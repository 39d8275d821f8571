"""Radiation: solar forcing, clouds, 2-band shortwave, 4-band longwave.

Counterpart of the JAX package's physics/radiation.py (the reference's
phy_radiat.f90: sol_oz/solar/cloud/radsw/radlw/radset).  The flux
recursions are short static loops over K levels and up to 4 bands over
(lat, lon) planes.  The longwave band fractions evaluate the reference's
integer-temperature table as its quadratics at round(T), which gives the
table exactly without a gather.  Level indices that depend on the data
(icltop) enter as comparisons, never as host reads.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from speedy_ml_tpu_torch.physics import constants as pc


def build_fband() -> np.ndarray:
    """LW band energy fractions vs temperature (radset,
    phy_radiat.f90:659-692): (301, 4) indexed by round(T)-100, T clipped
    to [100, 400]."""
    fband = np.zeros((401, 4))
    eps1 = 1.0 - pc.EPSLW
    for jtemp in range(200, 321):
        fband[jtemp, 1] = (0.148 - 3.0e-6 * (jtemp - 247) ** 2) * eps1
        fband[jtemp, 2] = (0.356 - 5.2e-6 * (jtemp - 282) ** 2) * eps1
        fband[jtemp, 3] = (0.314 + 1.0e-5 * (jtemp - 315) ** 2) * eps1
        fband[jtemp, 0] = eps1 - fband[jtemp, 1:4].sum()
    fband[100:200] = fband[200]
    fband[321:401] = fband[320]
    return fband[100:401]


def _fband_lookup(fband_tab, ta: torch.Tensor, jb: int) -> torch.Tensor:
    """LW band fraction at round(T): the quadratics of radset
    (phy_radiat.f90:677-691) at round(T) clipped to [200, 320], which is
    the table exactly.  fband_tab is unused (kept for the signature)."""
    tc = torch.clamp(torch.round(ta), 200.0, 320.0)
    eps1 = 1.0 - pc.EPSLW
    f2 = (0.148 - 3.0e-6 * (tc - 247.0) ** 2) * eps1
    if jb == 1:
        return f2
    f3 = (0.356 - 5.2e-6 * (tc - 282.0) ** 2) * eps1
    if jb == 2:
        return f3
    f4 = (0.314 + 1.0e-5 * (tc - 315.0) ** 2) * eps1
    if jb == 3:
        return f4
    return eps1 - (f2 + f3 + f4)


class SolarForcing(NamedTuple):
    """Zonally uniform daily radiative forcing (sol_oz), (lat, lon) each."""
    fsol: torch.Tensor
    ozupp: torch.Tensor
    ozone: torch.Tensor
    zenit: torch.Tensor
    stratz: torch.Tensor


def solar_flux_traced(tyear, csol: float, slat: torch.Tensor,
                      clat: torch.Tensor) -> torch.Tensor:
    """Daily-mean TOA insolation, Hartmann (1994) (phy_radiat.f90:77-121).

    tyear is a 0-d tensor (or float) on the device of slat/clat; the
    arithmetic runs in slat's dtype, as the JAX version does."""
    tyear = torch.as_tensor(tyear, dtype=slat.dtype, device=slat.device)
    alpha = 2.0 * math.pi * tyear
    ca1, sa1 = torch.cos(alpha), torch.sin(alpha)
    ca2, sa2 = ca1 * ca1 - sa1 * sa1, 2 * sa1 * ca1
    ca3, sa3 = ca1 * ca2 - sa1 * sa2, sa1 * ca2 + sa2 * ca1
    decl = (0.006918 - 0.399912 * ca1 + 0.070257 * sa1 - 0.006758 * ca2
            + 0.000907 * sa2 - 0.002697 * ca3 + 0.001480 * sa3)
    fdis = 1.000110 + 0.034221 * ca1 + 0.001280 * sa1 + 0.000719 * ca2 \
        + 0.000077 * sa2
    cdecl, sdecl = torch.cos(decl), torch.sin(decl)
    tdecl = sdecl / cdecl
    csolp = csol / math.pi
    ch0 = torch.clamp(-tdecl * slat / clat, -1.0, 1.0)
    h0 = torch.arccos(ch0)
    sh0 = torch.sin(h0)
    return csolp * fdis * (h0 * slat * sdecl + sh0 * clat * cdecl)


def sol_oz_traced(tyear, slat: torch.Tensor, clat: torch.Tensor,
                  nlon: int) -> SolarForcing:
    """Zonal solar/ozone forcing for one date (phy_radiat.f90:1-75);
    tyear a 0-d tensor on the device (no host read)."""
    tyear = torch.as_tensor(tyear, dtype=slat.dtype, device=slat.device)
    alpha = 2.0 * math.pi * (tyear + 10.0 / 365.0)
    coz1 = torch.clamp(torch.cos(alpha), min=0.0)
    coz2 = 1.8
    rzen = -torch.cos(alpha) * 23.45 * math.pi / 180.0
    czen, szen = torch.cos(rzen), torch.sin(rzen)
    fs0 = 6.0
    fsol = solar_flux_traced(tyear, 4.0 * pc.SOLC, slat, clat)
    flat2 = 1.5 * slat ** 2 - 0.5
    ozone = 0.4 * pc.EPSSW * (1.0 + coz1 * slat + coz2 * flat2)
    zenit = 1.0 + 1.0 * (1.0 - (clat * czen + slat * szen)) ** 2
    ozupp = fsol * (0.5 * pc.EPSSW) * zenit
    ozone = fsol * ozone * zenit
    stratz = torch.clamp(fs0 - fsol, min=0.0)
    tile = lambda z: z[:, None].expand(slat.shape[0], nlon)
    return SolarForcing(fsol=tile(fsol), ozupp=tile(ozupp),
                        ozone=tile(ozone), zenit=tile(zenit),
                        stratz=tile(stratz))


def cloud(qa, rh, precnv, precls, iptop, gse, fmask):
    """Cloud cover and top (phy_radiat.f90:123-233).
    Returns (icltop, cloudc, clstr, qcloud)."""
    K = qa.shape[0]
    nl1 = K - 2
    rrcl = 1.0 / (pc.RHCL2 - pc.RHCL1)
    zero = torch.zeros_like(rh[nl1])
    cloudc = torch.where(rh[nl1] > pc.RHCL1, rh[nl1] - pc.RHCL1, zero)
    icltop = torch.where(rh[nl1] > pc.RHCL1, nl1, K)
    for k in range(2, K - 2):
        drh = rh[k] - pc.RHCL1
        better = (drh > cloudc) & (qa[k] > pc.QACL)
        cloudc = torch.where(better, drh, cloudc)
        icltop = torch.where(better, k, icltop)
    cl1 = torch.clamp(cloudc * rrcl, max=1.0)
    pr1 = torch.clamp(86.4 * (precnv + precls), max=pc.PMAXCL)
    cloudc = torch.clamp(pc.WPCL * torch.sqrt(pr1) + cl1 * cl1, max=1.0)
    icltop = torch.minimum(iptop, icltop)
    qcloud = qa[nl1]
    # stratiform clouds at PBL top
    clfact = 1.2
    rgse = 1.0 / (pc.GSE_S1 - pc.GSE_S0)
    fstab = torch.clamp(rgse * (gse - pc.GSE_S0), 0.0, 1.0)
    clstr = fstab * torch.clamp(pc.CLSMAX - clfact * cloudc, min=0.0)
    clstrl = torch.clamp(clstr, min=pc.CLSMINL) * rh[K - 1]
    clstr = clstr + fmask * (clstrl - clstr)
    return icltop, cloudc, clstr, qcloud


def radsw(psa, qa, icltop, cloudc, clstr, qcloud, sol: SolarForcing,
          albsfc, *, sig, dsig):
    """Shortwave radiation + LW transmissivity setup
    (phy_radiat.f90:235-435).  Returns (ssrd, ssr, tsr, dfabs_sw, tau2,
    stratc)."""
    K = qa.shape[0]
    fband2 = 0.05
    fband1 = 1.0 - fband2
    zero = torch.zeros_like(psa)

    # SW cloud reflectivity (the band-3 slot of the reference's tau2)
    lev_ok = icltop <= K - 1
    tau_refl = [torch.where((icltop == k) & lev_ok, pc.ALBCL * cloudc, zero)
                for k in range(K)]
    tau_refl[K - 1] = pc.ALBCLS * clstr
    psaz = psa * sol.zenit
    acloud = cloudc * torch.clamp(pc.ABSCL1 * qcloud, max=pc.ABSCL2)

    tau1, taunir = [], []
    for k in range(K):
        deltap = psaz * float(dsig[k])
        if k == 0:
            t = torch.exp(-deltap * pc.ABSDRY)
        else:
            abs1 = pc.ABSDRY + pc.ABSAER * float(sig[k]) ** 2
            if k < K - 1:
                t = torch.where(
                    k >= icltop,
                    torch.exp(-deltap * (abs1 + pc.ABSWV1 * qa[k] + acloud)),
                    torch.exp(-deltap * (abs1 + pc.ABSWV1 * qa[k])))
            else:
                t = torch.exp(-deltap * (abs1 + pc.ABSWV1 * qa[k]))
        tau1.append(t)
        taunir.append(torch.exp(-deltap * pc.ABSWV2 * qa[k]) if k > 0
                      else torch.ones_like(psa))

    ftop = sol.fsol
    flux1 = sol.fsol * fband1
    flux2 = sol.fsol * fband2
    dfabs = [zero] * K
    # stratosphere: ozone absorption
    dfabs[0] = flux1
    flux1 = tau1[0] * (flux1 - sol.ozupp * psa)
    dfabs[0] = dfabs[0] - flux1
    dfabs[1] = flux1
    flux1 = tau1[1] * (flux1 - sol.ozone * psa)
    dfabs[1] = dfabs[1] - flux1
    # troposphere: cloud reflection + absorption
    for k in range(2, K):
        refl = flux1 * tau_refl[k]
        flux1 = flux1 - refl
        dfabs[k] = flux1
        flux1 = tau1[k] * flux1
        dfabs[k] = dfabs[k] - flux1
        tau_refl[k] = refl            # reflected flux, reused upward
    for k in range(1, K):
        dfabs[k] = dfabs[k] + flux2
        flux2 = taunir[k] * flux2
        dfabs[k] = dfabs[k] - flux2
    ssrd = flux1 + flux2
    flux1 = flux1 * albsfc
    ssr = ssrd - flux1
    # upward absorption and cloud re-reflection
    for k in range(K - 1, -1, -1):
        dfabs[k] = dfabs[k] + flux1
        flux1 = tau1[k] * flux1
        dfabs[k] = dfabs[k] - flux1
        flux1 = flux1 + tau_refl[k]
    tsr = ftop - flux1

    # LW transmissivity (tau2) for radlw
    acloud_lw = cloudc * pc.ABLCL2
    one = torch.ones_like(psa)
    tau2 = []
    for k in range(K):
        deltap = psa * float(dsig[k])
        t1 = torch.exp(-deltap * pc.ABLWIN)
        t2 = torch.exp(-deltap * pc.ABLCO2)
        if k == 0:
            t3 = t4 = one
        elif k == 1 or k == K - 1:
            t3 = torch.exp(-deltap * pc.ABLWV1 * qa[k])
            t4 = torch.exp(-deltap * pc.ABLWV2 * qa[k])
        else:
            acl1 = torch.where(k < icltop, acloud_lw, pc.ABLCL1 * cloudc)
            t1 = torch.exp(-deltap * (pc.ABLWIN + acl1))
            t3 = torch.exp(-deltap * torch.maximum(pc.ABLWV1 * qa[k],
                                                   acloud_lw))
            t4 = torch.exp(-deltap * torch.maximum(pc.ABLWV2 * qa[k],
                                                   acloud_lw))
        tau2.append(torch.stack([t1, t2, t3, t4]))
    eps1 = pc.EPSLW / float(dsig[0] + dsig[1])
    stratc = torch.stack([sol.stratz * psa, eps1 * psa])
    return ssrd, ssr, tsr, torch.stack(dfabs), torch.stack(tau2), stratc


def radlw_down(ta, tau2, fband_tab, *, wvi2, dsig, sbc):
    """Downward LW (radlw imode=-1, phy_radiat.f90:484-584).
    Returns (slrd, dfabs, flux_bands, st4a) for radlw_up; wvi2 numpy."""
    K = ta.shape[0]
    zero = torch.zeros_like(ta[0])
    thalf = [ta[k] + float(wvi2[k]) * (ta[k + 1] - ta[k])
             for k in range(K - 1)]
    t_strat1 = 0.75 * ta[0] + 0.25 * thalf[0]
    t_strat2 = 0.50 * ta[1] + 0.25 * (thalf[0] + thalf[1])
    anis, anish = 1.0, 0.5
    grads = [zero, zero]
    for k in range(2, K - 1):
        grads.append(anish * torch.clamp(thalf[k] - thalf[k - 1], min=0.0))
    grads.append(anis * torch.clamp(ta[K - 1] - thalf[K - 2], min=0.0))
    st4a_mean = [sbc * t_strat1 ** 4, sbc * t_strat2 ** 4]
    st4a_grad = [zero, zero]
    for k in range(2, K):
        st3a = sbc * ta[k] ** 3
        st4a_mean.append(st3a * ta[k])
        st4a_grad.append(4.0 * st3a * grads[k])

    dfabs = [zero] * K
    flux = [zero] * 4
    for jb in range(2):
        emis = 1.0 - tau2[0, jb]
        brad = _fband_lookup(fband_tab, ta[0], jb) * (
            st4a_mean[0] + emis * st4a_grad[0])
        flux[jb] = emis * brad
        dfabs[0] = dfabs[0] - flux[jb]
    for jb in range(4):
        for k in range(1, K):
            emis = 1.0 - tau2[k, jb]
            brad = _fband_lookup(fband_tab, ta[k], jb) * (
                st4a_mean[k] + emis * st4a_grad[k])
            dfabs[k] = dfabs[k] + flux[jb]
            flux[jb] = tau2[k, jb] * flux[jb] + emis * brad
            dfabs[k] = dfabs[k] - flux[jb]
    slrd = zero
    for jb in range(4):
        slrd = slrd + pc.EMISFC * flux[jb]
    # "black" band correction incl. surface reflection
    corlw = pc.EPSLW * pc.EMISFC * st4a_mean[K - 1]
    dfabs[K - 1] = dfabs[K - 1] - corlw
    slrd = slrd + corlw
    st4a = (torch.stack(st4a_mean), torch.stack(st4a_grad))
    return slrd, torch.stack(dfabs), torch.stack(flux), st4a


def radlw_up(ta, ts, slrd, slru_sfc, dfabs, flux_bands, st4a, tau2, stratc,
             fband_tab, *, dsig, sbc):
    """Upward LW (radlw imode=+1, phy_radiat.f90:600-656); slru_sfc the
    upward surface emission from suflux.  Returns (slr_net, olr, dfabs)."""
    K = ta.shape[0]
    st4a_mean, st4a_grad = st4a
    refsfc = 1.0 - pc.EMISFC
    slr = slru_sfc - slrd
    flux = [_fband_lookup(fband_tab, ts, jb) * slru_sfc
            + refsfc * flux_bands[jb] for jb in range(4)]
    dfabs = [dfabs[k] for k in range(K)]
    dfabs[K - 1] = dfabs[K - 1] + pc.EPSLW * slru_sfc
    for jb in range(4):
        for k in range(K - 1, 0, -1):
            emis = 1.0 - tau2[k, jb]
            brad = _fband_lookup(fband_tab, ta[k], jb) * (
                st4a_mean[k] - emis * st4a_grad[k])
            dfabs[k] = dfabs[k] + flux[jb]
            flux[jb] = tau2[k, jb] * flux[jb] + emis * brad
            dfabs[k] = dfabs[k] - flux[jb]
    for jb in range(2):
        emis = 1.0 - tau2[0, jb]
        brad = _fband_lookup(fband_tab, ta[0], jb) * (
            st4a_mean[0] - emis * st4a_grad[0])
        dfabs[0] = dfabs[0] + flux[jb]
        flux[jb] = tau2[0, jb] * flux[jb] + emis * brad
        dfabs[0] = dfabs[0] - flux[jb]
    corlw1 = float(dsig[0]) * stratc[1] * st4a_mean[0] + stratc[0]
    corlw2 = float(dsig[1]) * stratc[1] * st4a_mean[1]
    dfabs[0] = dfabs[0] - corlw1
    dfabs[1] = dfabs[1] - corlw2
    olr = corlw1 + corlw2
    for jb in range(4):
        olr = olr + flux[jb]
    return slr, olr, torch.stack(dfabs)
