"""The dycore step over a device mesh (GCM.set_mesh): the JAX package's
m-sharded spectral core and lat-sharded grid, spelled out.

Shard d holds the zonal wavenumbers ranges[d] of the spectral state and
the latitude band bands[d] of the grid (parallel/mesh.py GridShards;
DycoreModel.shard_view is its tables).  One step (DycoreModel.step's
order) is, on every shard:
  K15 on its m range (the dynamics and physics stacks of its range),
  the stacks' ranges joined on every shard (an all-gather: the sum over
     m of the synthesis then runs in one kernel, in its order),
  K6 into its band (the dynamics stack; the physics' own K6 its physics
     stack), the physics on its band (the callback of the shard),
  K7 on its band's columns,
  the K7 stacks' bands joined on every shard (an all-gather: the
     analysis' sum over latitudes runs in one kernel, in its order),
  K5 into its m range, K8 on its m range (the semi-implicit solve, the
     diffusion and the leapfrog filter are elementwise in m).
With cgrate_on, K8 runs its tendency form and K26 follows in two forms:
its rows form on each m range (the per-(level, m) sums over n), the rows
all-gathered in m order, and its range form on each range (each level's
sum over m from m = 0 in one thread, as the whole kernel sums it, then the
damping and the leapfrog of the range).  With RDF the physics of every
band runs its column kernels first; physics_join (GCM's) then gathers
RDF's sums and finishes each band (K25's band form, then SPPT).
No value is summed across shards in another order than the whole step's,
so every output is the unsharded step's bit for bit on the card; on the
CPU the plain versions' matrix products may round a sliced table's
product differently in the last bit.
K7 runs on the bands, not whole on one device: its columns are
independent, and the band's grid is where K6 and the physics put it.
"""

from __future__ import annotations

from typing import Optional

from speedy_ml_tpu_torch.dycore.model import DycoreModel, GridTendencies
from speedy_ml_tpu_torch.dycore.state import SpectralState
from speedy_ml_tpu_torch.kernels.cgrate import cgrate_range, cgrate_rows
from speedy_ml_tpu_torch.kernels.grid_dynamics import grid_dynamics
from speedy_ml_tpu_torch.kernels.spectral_stack import (dynamics_ncos,
                                                        spectral_stack)
from speedy_ml_tpu_torch.kernels.spectral_tail import spectral_tail
from speedy_ml_tpu_torch.parallel.mesh import Sharded


class ShardedDycore:
    """The dycore's step functions over the shards of a meshed
    SpectralTransform (sht.set_mesh).  States are Sharded SpectralStates
    (each shard's m range), phis and the corrections Sharded m ranges;
    the physics callbacks and their arguments one a shard."""

    def __init__(self, dyn: DycoreModel, sht):
        self.dyn = dyn
        self.grid = sht.grid
        self.dyns = [dyn.shard_view(s, b)
                     for s, b in zip(sht.shards, self.grid.bands)]

    def split_state(self, state: SpectralState) -> Sharded:
        """A whole SpectralState (on shard 0) as each shard's m range."""
        per = {f: self.grid.split_ranges(getattr(state, f))
               for f in SpectralState.FIELDS}
        return Sharded(SpectralState(**{f: per[f][d] for f in per})
                       for d in range(self.grid.D))

    def join_state(self, states, dst: int = 0) -> SpectralState:
        """The m ranges joined into a whole SpectralState on shard dst."""
        return SpectralState(**{
            f: self.grid.join_ranges([getattr(s, f) for s in states], dst)
            for f in SpectralState.FIELDS})

    def step(self, states, phis, j1: int, j2: int, dt: float, imp: str,
             physics_fns=None, physics_args=None,
             corrections: Optional[list] = None, physics_join=None):
        """DycoreModel.step on the shards: imp the name of the step
        length's coefficients ("imp_half", "imp_full" or "imp_double");
        physics_fns[d] shard d's callback, called as DycoreModel.step
        calls its own with physics_args[d]; corrections[d] shard d's
        (tcorh, qcorh) ranges or None; physics_join: None, or a function
        of (the tendencies, the aux) of every shard, called once all of
        them are made, that returns them finished.  Returns (Sharded new
        states, the callbacks' aux a shard, or None without physics)."""
        grid, dyns = self.grid, self.dyns
        g = self.dyn.geom
        D = grid.D
        phys = physics_fns is not None
        stacks = [spectral_stack(dn, s, p, j2 - 1, 0 if phys else None)
                  for dn, s, p in zip(dyns, states, phis)]        # K15
        dyn_all = grid.all_ranges([s[0] for s in stacks])
        phy_all = (grid.all_ranges([s[1] for s in stacks]) if phys
                   else [None] * D)
        ncos = dynamics_ncos(g.nlev, g.ntracers)
        galls = [dn.sht.synthesis(a, ncos)
                 for dn, a in zip(dyns, dyn_all)]                 # K6
        ptends, auxs = [None] * D, None
        if phys:
            auxs = []
            for d in range(D):
                out = physics_fns[d](states[d], 0, dyns[d],
                                     *physics_args[d], stack=phy_all[d])
                if isinstance(out, tuple) and not isinstance(
                        out, GridTendencies):
                    ptends[d], aux = out
                else:
                    ptends[d], aux = out, None
                auxs.append(aux)
            if physics_join is not None:
                ptends, auxs = physics_join(ptends, auxs)
        bands = [grid_dynamics(ga, pt, dn.column_tables(getattr(dn, imp)),
                               g.nlev, g.ntracers)
                 for dn, ga, pt in zip(dyns, galls, ptends)]      # K7
        whole = grid.all_bands(bands)
        A = [dn.analysis_stack(w) for dn, w in zip(dyns, whole)]  # K5
        if dt <= 0.0:
            return states, auxs
        eps = 0.0 if j1 == 1 else self.dyn.rob
        implicit = self.dyn.alph != 0.0
        corrections = corrections or [None] * D
        cg = self.dyn.cgrate_on
        new = [spectral_tail(dn, a, s, p, c, getattr(dn, imp), j1, dt, eps,
                             0 if implicit else j2 - 1, implicit, cg)
               for dn, a, s, p, c in zip(dyns, A, states, phis,
                                         corrections)]              # K8
        if cg:                                                      # K26
            rows = grid.all_ranges([cgrate_rows(dn, s, n) for dn, s, n
                                    in zip(dyns, states, new)], dim=-1)
            new = [cgrate_range(dn, s, n, r, j1, dt, eps) for dn, s, n, r
                   in zip(dyns, states, new, rows)]
        return Sharded(new), auxs

    def stepone(self, states, phis, physics_fns=None, physics_args=None,
                corrections=None, physics_join=None):
        """DycoreModel.stepone on the shards."""
        states, aux = self.step(states, phis, 1, 1, 0.5 * self.dyn.delt,
                                "imp_half", physics_fns, physics_args,
                                corrections, physics_join)
        return self.step(states, phis, 1, 2, self.dyn.delt, "imp_full",
                         physics_fns, physics_args, corrections,
                         physics_join)

    def leapfrog_step(self, states, phis, physics_fns=None,
                      physics_args=None, corrections=None,
                      physics_join=None):
        """DycoreModel.leapfrog_step on the shards."""
        return self.step(states, phis, 2, 2, self.dyn.delt2, "imp_double",
                         physics_fns, physics_args, corrections,
                         physics_join)
