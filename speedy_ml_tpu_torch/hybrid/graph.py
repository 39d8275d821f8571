"""The batched prediction loop's dispatch (cycles_per_dispatch > 1).

The JAX package runs K cycles of the hybrid as one lax.scan dispatch
(speedy_ml_tpu/hybrid/driver.py:195-309, _run_prediction_batched): the
per-cycle records stay on the device and come back stacked.  The port's
counterpart is CycleDispatch.dispatch: k cycles whose records go into a
(K, width) buffer on the hybrid's device, one row a cycle
(record_fields: the stream's fields, the state's SST grid and the gate's
flag, in the hybrid's dtype).

One body, two ways to run it.  The body is one cycle,
HybridAtmosphere.cycle_with_params with the cycle's row of per-cycle
scalars (hybrid/model.py ROW_*, HybridAtmosphere.scalar_row), followed
by its record.
  - On the CPU the body runs eagerly, cycle after cycle, through the
    plain versions.
  - On CUDA the body is captured with torch.cuda.CUDAGraph, once per form
    of the cycle, and replayed.  The state lives in static buffers that
    the graph reads and writes; the kernels that read the date (K17,
    K21, K23, K3 and K22's push) take it, in their device-scalar forms,
    from a static row that the host refills before each replay by one
    device-to-device copy from the dispatch's block of rows (uploaded
    once a dispatch from pinned memory); each replay's record is copied
    into its slot.  So a dispatch issues three things a cycle, the row's
    copy, the replay and the record's copy, and never waits for the card.
    A capture that fails raises: the cycles never run eagerly on the card
    instead.

On a mesh (HybridAtmosphere.set_mesh) the body is the meshed cycle, and
the state's regions and slab-ocean states are Sharded, each shard's
static buffer on its shard's device.  Which way it runs depends only on
the mesh:
  - every shard on one card (Mesh([cuda:0] * D)): captured and replayed
    as above, each form one graph;
  - shards on several cards: a capture on one card's stream does not
    record the work queued on the others, so each dispatch runs its
    cycles eagerly on the cards (the route chosen here over capturing
    across the cards with events), reading the dispatch's block of rows
    on the card and writing each record into the device buffer: one
    upload and one host copy a dispatch, as captured.
  Neither route is taken because the other failed.

The forms are keyed on the host step: the persistent surface's coupling
cycles (step % 4 == 3) and the slab ocean's slab steps (step %
SLAB_STRIDE == SLAB_STRIDE - 1) are forms of their own.  The first
persistent cycle, which starts the carried surface from the climatology,
runs eagerly before the first capture.  A capture bakes in the addresses
of the parameters, the tables and the static buffers: when one of them
changes (cast_wout_bf16, set_sst_table, a state of another structure)
the captured forms are dropped and captured anew.

Before a capture the body runs once for real on a scratch copy of the
state, on a side stream, so that the wrappers' first-call setup (the
library's build and load, cudaFuncSetAttribute) happens outside the
capture and the ring that K22 writes in place does not advance twice.
The kernels' launch counters count Python calls: the warm-up's and the
capture's are taken back, and each replay adds the counts of its
capture.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib
import inspect
import math
import pkgutil

import torch

from speedy_ml_tpu_torch.hybrid.model import ROW_LEN


def tree_map(fn, obj):
    """obj with fn applied to each tensor in it (through dataclasses,
    NamedTuples, tuples and lists; anything else as it is)."""
    if torch.is_tensor(obj):
        return fn(obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: tree_map(fn, getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*[tree_map(fn, v) for v in obj])
    if isinstance(obj, (tuple, list)):
        return type(obj)(tree_map(fn, v) for v in obj)
    return obj


def tree_tensors(obj) -> list:
    """The tensors in obj, in tree_map's order."""
    out = []
    tree_map(lambda t: out.append(t) or t, obj)
    return out


@functools.cache
def launch_counters() -> tuple:
    """(wrapper, attribute) of every launch counter of the port's kernels:
    the `launches` and `dev_launches` of the functions of
    speedy_ml_tpu_torch.kernels' modules."""
    import speedy_ml_tpu_torch.kernels as kp
    found = []
    for info in pkgutil.iter_modules(kp.__path__):
        mod = importlib.import_module(f"{kp.__name__}.{info.name}")
        for fn in vars(mod).values():
            if inspect.isfunction(fn) and fn.__module__ == mod.__name__:
                found += [(fn, a) for a in ("launches", "dev_launches")
                          if isinstance(getattr(fn, a, None), int)]
    return tuple(found)


def _counts() -> list:
    return [getattr(fn, a) for fn, a in launch_counters()]


def record_fields(hyb) -> list:
    """(name, shape) of a cycle's record, in its order: atmo, logp,
    precip, with emit_components the six v_p/v_ml grids, then sst (the
    new state's SST grid) and safe (the gate's flag, 1 or 0)."""
    g = hyb.geom
    grid = (g.nlat, g.nlon)
    base = [("atmo", (hyb.NVAR, hyb.nz) + grid), ("logp", grid),
            ("precip", grid)]
    comps = [(f"{p}_{nm}", shape) for p in ("vp", "vml")
             for nm, shape in base] if hyb.emit_components else []
    return base + comps + [("sst", grid), ("safe", ())]


def record_width(hyb) -> int:
    return sum(math.prod(shape) for _, shape in record_fields(hyb))


class _Form:
    """A captured form of the cycle: its graph and the launch counts that
    one replay adds."""

    def __init__(self, graph, counts):
        self.graph = graph
        self.counts = counts


class CycleDispatch:
    """Runs chunks of cycles of one HybridAtmosphere (dispatcher(hyb))."""

    def __init__(self, hyb):
        self.hyb = hyb
        self.static = None     # the HybridState of static buffers (CUDA)
        self._sig = None       # its structure
        self._ctx = None       # what the captured forms bake in
        self._forms = {}
        self._pool = None
        self._row = None       # the replayed row of per-cycle scalars
        self._rec = None       # the replayed record
        self._host = None      # pinned host copy of the records
        self.captures = 0      # forms captured so far

    # ---------------------------------------------------------------- API

    def records(self, K: int) -> torch.Tensor:
        """A (K, record_width) buffer for dispatch, on the hybrid's device
        in its dtype."""
        return torch.empty((K, record_width(self.hyb)), dtype=self.hyb.dtype,
                           device=self.hyb.device)

    def dispatch(self, state, dates, records: torch.Tensor):
        """Run len(dates) cycles from `state` and write their records into
        records[:len(dates)].  dates: per cycle (imon, fmon, tyear,
        hour_of_year, sst_bias), host numbers, the cycles at state.step,
        state.step + 1, ...  Returns the state after the last cycle: on
        CUDA its tensors are this dispatcher's static buffers, which the
        next dispatch reads and overwrites (result() copies them).  On
        CUDA nothing here waits for the card once each form met in the
        run is captured."""
        hyb = self.hyb
        params = hyb.params
        rows = [hyb.scalar_row(*d, step=state.step + j)
                for j, d in enumerate(dates)]
        mesh = getattr(hyb, "mesh", None)
        if hyb.device.type == "cuda" and mesh is not None and len(
                set(mesh.devices)) > 1:
            # shards on several cards: the cycles run eagerly on them
            block = torch.tensor(rows, dtype=torch.float64).pin_memory().to(
                hyb.device, non_blocking=True)
            for j, d in enumerate(dates):
                state, rec = self._body(params, state, d, block[j])
                records[j].copy_(rec)
            return state
        if hyb.device.type != "cuda":
            for j, d in enumerate(dates):
                row = torch.tensor(rows[j], dtype=torch.float64)
                state, rec = self._body(params, state, d, row)
                records[j].copy_(rec)
            return state
        j0 = 0
        if (not hyb.ml_only and hyb.persist_surface and state.sfc is None
                and dates):
            # the first persistent cycle starts the carried surface from
            # the climatology: eagerly, as the per-cycle loop runs it
            state, rec = self._body(params, state, dates[0], None)
            records[0].copy_(rec)
            j0 = 1
        if j0 == len(dates):
            return state
        self._load(state)
        self._context(params)
        block = torch.tensor(rows[j0:], dtype=torch.float64).pin_memory().to(
            hyb.device, non_blocking=True)
        counters = launch_counters()
        for j in range(j0, len(dates)):
            step = state.step + j - j0
            form = self._forms.get(self._form_key(step))
            if form is None:
                form = self._capture(params, dates[j], step, block[j - j0])
            self._row.copy_(block[j - j0], non_blocking=True)
            form.graph.replay()
            for (fn, a), n in zip(counters, form.counts):
                if n:
                    setattr(fn, a, getattr(fn, a) + n)
            records[j].copy_(self._rec, non_blocking=True)
        return dataclasses.replace(self.static,
                                   step=state.step + len(dates) - j0)

    def fetch(self, records: torch.Tensor, k: int):
        """Start the copy of records[:k] to the host (on CUDA into pinned
        memory, non_blocking, with an event); returns what wait() takes."""
        if records.device.type != "cuda":
            return records[:k], None
        if self._host is None or self._host.shape[0] < records.shape[0] \
                or self._host.shape[1:] != records.shape[1:] \
                or self._host.dtype != records.dtype:
            self._host = torch.empty(records.shape, dtype=records.dtype,
                                     pin_memory=True)
        self._host[:k].copy_(records[:k], non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return self._host[:k], event

    def wait(self, fetched) -> dict:
        """The fetched records as host numpy arrays (k, *shape) by name
        (record_fields), copies of their own."""
        flat, event = fetched
        if event is not None:
            event.synchronize()
        flat = flat.numpy()
        out, start = {}, 0
        for nm, shape in record_fields(self.hyb):
            n = math.prod(shape)
            out[nm] = flat[:, start:start + n].reshape(
                (flat.shape[0],) + shape).copy()
            start += n
        return out

    def result(self, state):
        """The state as a caller keeps it: on CUDA a copy of the static
        buffers that dispatch returned, which the next dispatch
        overwrites."""
        if self.static is None or \
                state.classes[0].x is not self.static.classes[0].x:
            return state
        return tree_map(lambda t: t.clone(), state)

    # ---------------------------------------------------------- the body

    def _body(self, params, state, date, row):
        """One cycle and its record (record_fields, joined)."""
        hyb = self.hyb
        new, diag = hyb.cycle_with_params(params, state, *date,
                                          scalars=row)
        dt = hyb.dtype
        parts = [diag[nm].reshape(-1).to(dt)
                 for nm, _ in record_fields(hyb)[:-2]]
        parts.append(new.sst_grid.reshape(-1).to(dt))
        if torch.is_tensor(new.safe):
            parts.append(new.safe.reshape(1).to(dt))
        else:
            parts.append(torch.full((1,), float(bool(new.safe)), dtype=dt,
                                    device=hyb.device))
        return new, torch.cat(parts)

    # --------------------------------------------------- the captured path

    def _form_key(self, step: int) -> tuple:
        """The host's choices of the cycle at `step`: the coupler's day
        (persistent surface) and the slab step (slab ocean)."""
        hyb = self.hyb
        cpd = 24 // hyb.TIMESTEP_HOURS
        couple = (not hyb.ml_only and hyb.persist_surface
                  and step % cpd == cpd - 1)
        slab = bool(hyb.ocean_packs) and \
            step % hyb.SLAB_STRIDE == hyb.SLAB_STRIDE - 1
        return couple, slab

    @staticmethod
    def _signature(state) -> tuple:
        return (tuple((tuple(t.shape), t.dtype, t.device)
                      for t in tree_tensors(state)),
                state.sfc is None, state.fluxes is None,
                tuple(o.lm is None for o in state.ocean),
                torch.is_tensor(state.safe))

    def _load(self, state):
        """Hold `state` in the static buffers (allocated, and the forms
        dropped, when its structure is new).  A coupled state's gate flag
        is held on the card, where the replays read and write it."""
        if not self.hyb.ml_only and not torch.is_tensor(state.safe):
            state = dataclasses.replace(state, safe=torch.full(
                (), bool(state.safe), device=self.hyb.device))
        sig = self._signature(state)
        if self.static is None or sig != self._sig:
            self._forms = {}
            self.static = tree_map(lambda t: t.clone(), state)
            self._sig = sig
            return
        for dst, src in zip(tree_tensors(self.static), tree_tensors(state)):
            if dst.data_ptr() != src.data_ptr():
                dst.copy_(src)

    def _context(self, params):
        """Drop the forms when what they bake in changed."""
        hyb = self.hyb
        ptr = lambda t: None if t is None else t.data_ptr()
        # on a mesh also the shards' parameters and the meshed GCM (its
        # tables are made by its set_mesh)
        sharded = (getattr(hyb, "_sharded_packs", None),
                   getattr(hyb, "_sharded_opacks", None))
        ctx = (tuple(t.data_ptr() for t in tree_tensors((params, sharded))),
               id(hyb.gcm), id(getattr(hyb, "mesh", None)),
               id(self.static), ptr(hyb.sst_table), ptr(hyb.tisr_table),
               hyb.tisr_hours_per_entry, hyb.emit_components,
               hyb.persist_surface, hyb.SLAB_STRIDE)
        if ctx != self._ctx:
            self._forms = {}
            self._ctx = ctx
            dev = hyb.device
            self._row = torch.zeros(ROW_LEN, dtype=torch.float64, device=dev)
            self._rec = torch.empty(record_width(hyb), dtype=hyb.dtype,
                                    device=dev)

    def _store(self, new):
        """Copy the cycle's new state into the static buffers (inside the
        capture).  A new tensor that shares memory with another static
        buffer is copied aside first."""
        dst, src = tree_tensors(self.static), tree_tensors(new)
        if len(dst) != len(src):
            raise RuntimeError("the cycle's state changed its structure "
                               "inside a captured form")
        mine = {t.untyped_storage().data_ptr() for t in dst}
        src = [s.clone() if s.data_ptr() != d.data_ptr()
               and s.untyped_storage().data_ptr() in mine else s
               for d, s in zip(dst, src)]
        for d, s in zip(dst, src):
            if s.data_ptr() != d.data_ptr():
                d.copy_(s)

    def _capture(self, params, date, step: int, row) -> _Form:
        """Warm the form up on a scratch copy of the state, then capture
        it; the counters keep neither's launches."""
        before = _counts()
        cur = torch.cuda.current_stream()
        scratch = tree_map(lambda t: t.clone(),
                           dataclasses.replace(self.static, step=step))
        side = torch.cuda.Stream()
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self._body(params, scratch, date, row)
        cur.wait_stream(side)
        torch.cuda.synchronize()
        del scratch
        warm = _counts()
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        st = dataclasses.replace(self.static, step=step)
        try:
            with torch.cuda.graph(graph, pool=self._pool):
                new, rec = self._body(params, st, date, self._row)
                self._store(new)
                self._rec.copy_(rec)
        except Exception as e:
            raise RuntimeError(f"capturing the hybrid cycle as a CUDA graph "
                               f"failed (form {self._form_key(step)}): "
                               f"{e}") from e
        after = _counts()
        for (fn, a), n in zip(launch_counters(), before):
            setattr(fn, a, n)
        form = _Form(graph, [a - w for a, w in zip(after, warm)])
        self.captures += 1
        self._forms[self._form_key(step)] = form
        return form


def dispatcher(hyb) -> CycleDispatch:
    """The hybrid's CycleDispatch (made at the first call, then kept; a
    copy of a hybrid, as set_mesh is run on, gets its own)."""
    d = getattr(hyb, "_cycle_dispatch", None)
    if d is None or d.hyb is not hyb:
        d = hyb._cycle_dispatch = CycleDispatch(hyb)
    return d
