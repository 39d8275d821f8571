"""Spherical-harmonic spectral transforms on one device.

Counterpart of the JAX package's core/spectral.py (the reference's
spe_spectral.f90): the same Legendre and operator tables, built in numpy
float64, the same hemispheric folding and truncation masks, and the
zonal leg as a DFT matrix product (the JAX package's zonal="dft", the
backend its GCM runs).  The two legs of each direction are one kernel:
grid_to_spec is K5 (kernels/sht_analysis.py) and spec_to_grid K6
(kernels/sht_synthesis.py); on a CPU tensor both run their plain
versions.

Layouts as in the JAX package:
- grid fields (..., nlat, nlon), latitude 0 = southernmost row;
- spectral fields complex (..., mx, nx), m = zonal wavenumber, the total
  wavenumber is m + n.

Precision: the tables and operators run in the model dtype (float32 on
the card, float64 in the tests) with no TF32 anywhere: reduced-precision
passes blow the T30 integration up after about 20 days.

On a mesh (set_mesh; the JAX package's m-sharding) shard d holds a view
of the transform (shard_view): the analysis tables and the spectral
operators of its zonal wavenumbers ranges[d], and the synthesis tables
of its latitude band bands[d] (parallel/mesh.py GridShards).  K5 of a
shard turns the whole grid into its m range; K6 of a shard turns the
whole spectrum, its m ranges joined on the shard, into its band.  No sum
crosses shards: each output is the unsharded kernel's, bit for bit (the
ranges are joined before the sum over m, not summed as partial grids).
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from speedy_ml_tpu_torch import resolve_device
from speedy_ml_tpu_torch.core.geometry import Geometry
from speedy_ml_tpu_torch.kernels.inject_spectral import inject_blob
from speedy_ml_tpu_torch.kernels.sht_analysis import sht_analysis
from speedy_ml_tpu_torch.kernels.sht_synthesis import sht_synthesis

def complex_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.complex128 if dtype == torch.float64 else torch.complex64


def legendre_tables(geom: Geometry) -> dict[str, np.ndarray]:
    """All Legendre/wavenumber tables in float64 numpy (parmtr/lgndre,
    spe_spectral.f90:45-242, 0-based)."""
    mx, nx, iy = geom.mx, geom.nx, geom.nlat_half
    mxp, nxp = geom.mx, geom.nx + 1  # recursion needs one extra row
    ntrun, ntrun1 = geom.trunc, geom.ntrun1
    sia, wt, coa = geom.sia, geom.wt, geom.coa

    m_idx = np.arange(mx)
    n_idx = np.arange(nx)
    ll = m_idx[:, None] + n_idx[None, :]          # total wavenumber l
    l2 = ll * (ll + 1)
    trfilt = (ll <= ntrun).astype(np.float64)
    mask_g = (ll <= ntrun1).astype(np.float64)    # transform mask (nsh2)
    mask_s = mask_g * (n_idx[None, :] <= ntrun1 - 1)  # specy skips n=nx-1

    me = np.arange(mxp)[:, None].astype(np.float64)
    elle = me + np.arange(nxp)[None, :]
    with np.errstate(divide="ignore", invalid="ignore"):
        epsi = np.sqrt((elle ** 2 - me ** 2) / (4.0 * elle ** 2 - 1.0))
    epsi[0, 0] = 0.0
    epsi[:, nxp - 1] = 0.0
    repsi = np.where(epsi > 0.0, 1.0 / np.where(epsi > 0, epsi, 1.0), 0.0)

    consq = np.zeros(mxp)
    consq[1:] = np.sqrt(0.5 * (2.0 * np.arange(1, mxp) + 1.0)
                        / np.arange(1, mxp))
    cpol = np.zeros((iy, mx, nx))
    for j in range(iy):
        x, y = sia[j], coa[j]
        alp = np.zeros((mxp, nx))
        alp[0, 0] = np.sqrt(0.5)
        for m in range(1, mxp):
            alp[m, 0] = consq[m] * y * alp[m - 1, 0]
        alp[:, 1] = (x * alp[:, 0]) * repsi[:, 1]
        for n in range(2, nx):
            alp[:, n] = (x * alp[:, n - 1]
                         - epsi[:, n - 1] * alp[:, n - 2]) * repsi[:, n]
        alp[np.abs(alp) <= 1e-30] = 0.0
        cpol[j] = alp[:mx, :]
    return dict(ll=ll, l2=l2, trfilt=trfilt, mask_g=mask_g, mask_s=mask_s,
                epsi=epsi, cpol=cpol, wt=wt)


def operator_tables(geom: Geometry, radius: float, tab: dict
                    ) -> dict[str, np.ndarray]:
    """Derivative/rotational operator tables (parmtr,
    spe_spectral.f90:153-175)."""
    mx, nx = geom.mx, geom.nx
    a = radius
    ll = tab["ll"].astype(np.float64)
    el2 = tab["l2"].astype(np.float64) / (a * a)
    elm2 = np.zeros_like(el2)
    elm2[el2 > 0] = 1.0 / el2[el2 > 0]
    m_idx = np.arange(mx).astype(np.float64)
    eps_m = tab["epsi"][:mx, :nx]
    eps_p = tab["epsi"][:mx, 1:nx + 1]

    gradym = np.zeros((mx, nx))
    gradyp = (ll + 2.0) * eps_p / a
    uvdx = np.zeros((mx, nx))
    uvdym = np.zeros((mx, nx))
    uvdyp = -a * eps_p / (ll + 1.0)
    vddym = np.zeros((mx, nx))
    vddyp = ll * eps_p / a
    uvdx[:, 0] = -a / (m_idx + 1.0)
    sl = np.s_[:, 1:]
    uvdx[sl] = -a * m_idx[:, None] / (ll[sl] * (ll[sl] + 1.0))
    gradym[sl] = (ll[sl] - 1.0) * eps_m[sl] / a
    uvdym[sl] = -a * eps_m[sl] / ll[sl]
    vddym[sl] = (ll[sl] + 1.0) * eps_m[sl] / a
    return dict(el2=el2, elm2=elm2, gradx=m_idx / a, gradym=gradym,
                gradyp=gradyp, uvdx=uvdx, uvdym=uvdym, uvdyp=uvdyp,
                vddym=vddym, vddyp=vddyp)


def shift_right(x: torch.Tensor) -> torch.Tensor:
    """x[..., n] -> x[..., n-1], zero at n=0 (last axis = n)."""
    return torch.cat([torch.zeros_like(x[..., :1]), x[..., :-1]], dim=-1)


def shift_left(x: torch.Tensor) -> torch.Tensor:
    """x[..., n] -> x[..., n+1], zero at n=nx-1."""
    return torch.cat([x[..., 1:], torch.zeros_like(x[..., :1])], dim=-1)


class SpectralTransform:
    """Batched spherical-harmonic transform for one geometry, with its
    tables as tensors on one device (default CUDA; raises without one)."""

    def __init__(self, geom: Geometry, radius: float = 6.371e6,
                 dtype=torch.float32, zonal: str = "dft", *, device=None):
        if zonal != "dft":
            raise ValueError("the port keeps one zonal backend, the DFT "
                             f"matrix product (zonal='dft'), not {zonal!r}")
        self.device = resolve_device(device)
        self.geom = geom
        self.radius = radius
        self.dtype = dtype
        self.cdtype = complex_dtype(dtype)
        self.zonal = zonal

        tab = legendre_tables(geom)
        ops = operator_tables(geom, radius, tab)
        f = lambda x: torch.as_tensor(np.asarray(x, dtype=np.float64),
                                      device=self.device).to(dtype)
        even_n = (np.arange(geom.nx) % 2 == 0).astype(np.float64)
        cg = tab["cpol"] * tab["mask_g"]
        cs = tab["cpol"] * tab["mask_s"]
        # Legendre matrices with masks and parity folded in (iy, mx, nx);
        # the kernels take the sum of the two parities (one is zero at
        # every entry, so the sum is exact)
        odd_n = 1.0 - even_n
        self.cpol_even_g, self.cpol_odd_g = f(cg * even_n), f(cg * odd_n)
        self.cpol_even_s, self.cpol_odd_s = f(cs * even_n), f(cs * odd_n)
        self.cpol_g, self.cpol_s = f(cg), f(cs)
        self.wt = f(tab["wt"])
        self.trfilt = f(tab["trfilt"])
        self.el2, self.elm2 = f(ops["el2"]), f(ops["elm2"])
        self.gradx = f(ops["gradx"])
        self.gradym, self.gradyp = f(ops["gradym"]), f(ops["gradyp"])
        self.uvdx = f(ops["uvdx"])
        self.uvdym, self.uvdyp = f(ops["uvdym"]), f(ops["uvdyp"])
        self.vddym, self.vddyp = f(ops["vddym"]), f(ops["vddyp"])
        # kills the i*m*f zonal-derivative term in the last n row, as the
        # reference's vds/uvspec do (spe_spectral.f90:330-337, 368-375)
        zrow = np.ones(geom.nx)
        zrow[-1] = 0.0
        self.zrow_mask = f(zrow)
        self.cosgr = f(1.0 / geom.cos_lat)
        self.cosgr2 = f(1.0 / geom.cos_lat ** 2)
        # the synthesis' 1/cos rows (a shard's: its band's)
        self.cosgr_g = self.cosgr

        # zonal DFT matrices, only the mx kept wavenumbers (nlon x mx)
        j = np.arange(geom.nlon)
        ang = 2.0 * np.pi * np.outer(j, np.arange(geom.mx)) / geom.nlon
        cm = np.ones(geom.mx)
        cm[1:] = 2.0
        c = lambda x: torch.as_tensor(np.ascontiguousarray(x),
                                      device=self.device).to(self.cdtype)
        self.dft_fwd = c(np.exp(-1j * ang) / geom.nlon)          # (nlon, mx)
        self.dft_inv = c((np.exp(1j * ang) * cm[None, :]).T)      # (mx, nlon)
        # complex tables times a real operand: the i*gradx factor
        self.igradx = (1j * self.gradx.to(self.cdtype))[:, None]
        # the tables of the injection's spectral glue (K18, phase 0 of
        # K6_inject), built once
        self.inject_blob = inject_blob(self)
        self.mesh = self.grid = self.shards = None
        self.m0 = 0   # a shard's first zonal wavenumber

    # ------------------------------------------------------------------
    # the mesh (m ranges and latitude bands)
    # ------------------------------------------------------------------

    M_TABLES = ("el2", "elm2", "gradym", "gradyp", "uvdx", "uvdym",
                "uvdyp", "vddym", "vddyp", "trfilt")

    def shard_view(self, mrange, band, device) -> "SpectralTransform":
        """A copy of this transform for one shard on `device`: K5's tables
        (dft_fwd's columns, the Legendre analysis rows) and the (m, n)
        operator tables of the wavenumbers mrange = (m0, m1); K6's tables
        (the Legendre synthesis rows, 1/cos) of the latitude band = (p0,
        p1) (parallel/mesh.py lat_bands); the (lat,) analysis factors
        whole.  Its analysis turns a whole grid into the range, its
        synthesis a whole spectrum into the band; its operators work on
        the range (they are elementwise in m)."""
        from speedy_ml_tpu_torch.parallel.mesh import band_rows
        v = copy.copy(self)
        v.mesh = v.grid = v.shards = None
        dev = torch.device(device)
        m0, m1 = mrange
        p0, p1 = band
        v.device, v.m0 = dev, m0
        to = lambda t: t.to(dev).contiguous()
        m = lambda t, dim: to(t.narrow(dim, m0, m1 - m0))
        v.dft_fwd = m(self.dft_fwd, 1)
        for nm in ("cpol_even_s", "cpol_odd_s", "cpol_s"):
            setattr(v, nm, m(getattr(self, nm), 1))
        for nm in self.M_TABLES:
            setattr(v, nm, m(getattr(self, nm), 0))
        v.gradx = m(self.gradx, 0)
        v.igradx = m(self.igradx, 0)
        for nm in ("cpol_even_g", "cpol_odd_g", "cpol_g"):
            setattr(v, nm, to(getattr(self, nm)[p0:p1]))
        v.cosgr_g = to(band_rows(self.cosgr, band, self.geom.nlat, dim=0))
        for nm in ("wt", "cosgr", "cosgr2", "zrow_mask", "dft_inv"):
            setattr(v, nm, to(getattr(self, nm)))
        v.inject_blob = None
        return v

    def set_mesh(self, mesh, axis: str = "regions"):
        """Shard the transforms over `mesh` (the JAX package's set_mesh,
        core/spectral.py:212-245): shard d gets shard_view of its m range
        and latitude band (parallel/mesh.py GridShards).  Afterwards
        grid_to_spec, spec_to_grid and uv_grid run on the shards: K5 a
        shard into its range, the ranges joined; the operators on the
        ranges; K6 a shard into its band from the joined spectrum, the
        bands joined; each takes and returns whole tensors on
        mesh.devices[0].  analysis and synthesis stay this device's whole
        transforms.  The DFT matrix product is the port's only zonal
        backend, so the JAX package's zonal='dft' condition always
        holds."""
        from speedy_ml_tpu_torch.parallel.mesh import GridShards
        d0, own = mesh.devices[0], self.cosgr.device
        if d0.type != own.type or (d0.index is not None
                                   and d0.index != own.index):
            raise ValueError(f"the mesh's first device {mesh.devices[0]} is "
                             f"not the transform's ({self.device})")
        g = self.geom
        self.grid = GridShards(mesh, g.nlat, g.mx)
        self.shards = [self.shard_view(r, b, dev) for r, b, dev in
                       zip(self.grid.ranges, self.grid.bands, mesh.devices)]
        self.mesh = mesh
        self.axis = axis

    def _to_bands(self, specs) -> torch.Tensor:
        """Whole spectra (B, mx, nx) on every shard -> each shard's band
        (K6 a shard) -> the bands joined on mesh.devices[0]."""
        return self.grid.join_bands([sh.synthesis(s[0], s[1]) for sh, s in
                                     zip(self.shards, specs)])

    # ------------------------------------------------------------------
    # transforms (K5 / K6)
    # ------------------------------------------------------------------

    def analysis(self, grid: torch.Tensor, n0: int | None = None,
                 pre: torch.Tensor | None = None) -> torch.Tensor:
        """(B, nlat, nlon) -> (B, mx, nx): grid_to_spec of every field,
        the fields from index n0 on first scaled by pre[lat] (default
        1/cos), as vdspec scales its u and v."""
        if n0 is None or n0 >= grid.shape[0]:
            n0, pre = grid.shape[0], None
        elif pre is None:
            pre = self.cosgr
        return sht_analysis(grid.contiguous(), self.dft_fwd, self.wt,
                            self.cpol_even_s, self.cpol_odd_s, self.cpol_s,
                            pre, n0)

    def synthesis(self, spec: torch.Tensor, ncos: int | None = None
                  ) -> torch.Tensor:
        """(B, mx, nx) -> (B, nlat, nlon): spec_to_grid of every field, the
        fields from index ncos on times 1/cos (kcos=2)."""
        B = spec.shape[0]
        return sht_synthesis(spec.contiguous(), self.dft_inv,
                             self.cpol_even_g, self.cpol_odd_g, self.cpol_g,
                             self.cosgr_g, B if ncos is None else ncos)

    def grid_to_spec(self, field: torch.Tensor) -> torch.Tensor:
        """Forward transform (spec = specy . specx) of (..., nlat, nlon)."""
        g = self.geom
        lead = field.shape[:-2]
        flat = field.to(self.dtype).reshape(-1, g.nlat, g.nlon)
        if self.mesh is None:
            out = self.analysis(flat)
        else:
            grid = self.grid
            out = grid.join_ranges([sh.analysis(f) for sh, f in
                                    zip(self.shards, grid.broadcast(flat))])
        return out.reshape(lead + (g.mx, g.nx))

    def spec_to_grid(self, v: torch.Tensor, kcos: int = 1) -> torch.Tensor:
        """Inverse transform of (..., mx, nx); kcos=2 multiplies by 1/cos."""
        g = self.geom
        lead = v.shape[:-2]
        flat = v.reshape(-1, g.mx, g.nx)
        ncos = 0 if kcos != 1 else None
        if self.mesh is None:
            out = self.synthesis(flat, ncos)
        else:
            out = self._to_bands([(s, ncos) for s in
                                  self.grid.broadcast(flat)])
        return out.reshape(lead + (g.nlat, g.nlon))

    # ------------------------------------------------------------------
    # spectral operators (elementwise in m; the shifts move n)
    # ------------------------------------------------------------------

    def vdspec(self, ug: torch.Tensor, vg: torch.Tensor, kcos: int = 2):
        """Grid u, v (B, nlat, nlon) -> spectral (vor, div)
        (spe_spectral.f90:416-452); one analysis launch for both."""
        B = ug.shape[0]
        a = self.analysis(torch.cat([ug, vg]).to(self.dtype), 0,
                          self.cosgr if kcos == 2 else self.cosgr2)
        return self.vds(a[:B], a[B:])

    def vds(self, ucosm, vcosm):
        """Spectral (u cos, v cos) -> (vor, div) (spe_spectral.f90:307-349)."""
        zp = self.igradx * ucosm * self.zrow_mask
        zc = self.igradx * vcosm * self.zrow_mask
        vorm = (self.vddym * shift_right(ucosm)
                - self.vddyp * shift_left(ucosm) + zc)
        divm = (-self.vddym * shift_right(vcosm)
                + self.vddyp * shift_left(vcosm) + zp)
        return vorm, divm

    def uvspec(self, vorm, divm):
        """Spectral (vor, div) -> spectral (u cos, v cos)
        (spe_spectral.f90:351-387)."""
        zp = 1j * self.uvdx * vorm * self.zrow_mask
        zc = 1j * self.uvdx * divm * self.zrow_mask
        ucosm = (self.uvdym * shift_right(vorm)
                 - self.uvdyp * shift_left(vorm) + zc)
        vcosm = (-self.uvdym * shift_right(divm)
                 + self.uvdyp * shift_left(divm) + zp)
        return ucosm, vcosm

    def uv_grid(self, vorm, divm):
        """Spectral vor/div (B, mx, nx) -> grid u, v (1/cos applied).  On
        a mesh uvspec runs on each shard's m range, and K6 on each band of
        the joined (u cos, v cos)."""
        flat = lambda a: a.reshape(-1, *a.shape[-2:])
        lead = torch.broadcast_shapes(vorm.shape, divm.shape)[:-2]
        if self.mesh is None:
            ucosm, vcosm = self.uvspec(vorm, divm)
            g = self.synthesis(torch.cat([flat(ucosm), flat(vcosm)]), 0)
        else:
            grid = self.grid
            uv = [torch.cat([flat(a) for a in sh.uvspec(vo, dv)])
                  for sh, vo, dv in zip(self.shards,
                                        grid.split_ranges(flat(vorm)),
                                        grid.split_ranges(flat(divm)))]
            g = self._to_bands([(s, 0) for s in grid.all_ranges(uv)])
        B = g.shape[0] // 2
        return (g[:B].reshape(lead + g.shape[-2:]),
                g[B:].reshape(lead + g.shape[-2:]))

    def grad(self, psi):
        """Spectral gradient (spe_spectral.f90:271-305): (d/dx, d/dy)."""
        psdx = self.igradx * psi
        psdy = -self.gradym * shift_right(psi) + self.gradyp * shift_left(psi)
        return psdx, psdy

    def lap(self, psi):
        return -psi * self.el2

    def invlap(self, vor):
        return -vor * self.elm2

    def trunct(self, v):
        return v * self.trfilt
