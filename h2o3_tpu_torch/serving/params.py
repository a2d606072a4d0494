"""Shared serving-param placements of the port (h2o3_tpu/serving/params.py)
— model params under a tier pager.

A model family exports a param PYTREE (`ModelBase._serving_params`: a
dict of the attributes `_serving_param_attrs` names, whose values are
tensors, numpy arrays, dataclasses, lists and dicts of them). The store
places it ONCE per model generation on the cloud's card, as fresh device
copies that every row-bucket program of the model reads, so per-model
HBM is constant in the number of buckets:

  * Placements are REFCOUNTED by the cache entries that dispatch them:
    each resident (model, bucket) program holds one reference; the last
    release (LRU, stale-generation purge, model DELETE) frees the
    placement exactly once. `h2o3_scorer_params_bytes{model}` tracks the
    per-model HBM occupancy.
  * Leaves keep their dtypes: the JAX package narrows f64 to f32 and i64
    to i32 only because of JAX's x64 default; here a demote→promote round
    trip returns every leaf bit for bit (the trees' int64-held uint32
    `catbits` included).
  * Every promotion bumps the placement's `gen`. A captured CUDA graph
    reads the addresses it was captured with, so a scorer program
    records the (placement, gen) it was captured against and captures
    again when they change (serving/scorer_cache.py) — it never replays
    against freed storage.

With `H2O3_SERVE_HBM_BUDGET_MB` set, a placement's refcount keeps it
REGISTERED but no longer keeps it DEVICE-RESIDENT. Params ride the same
three-tier ladder as chunk planes (core/tiering.py):

    HBM (placed tensors)  ⇄  host (pinned CPU tensors)  ⇄  npz under ice_root

  * PROMOTE places the host leaves; admission is reserved ATOMICALLY
    before any copy lands, so the `h2o3_scorer_params_bytes` sum never
    exceeds the budget, even under concurrent cold faults.
  * EVICTION is same-tenant-first LRU: victims are chosen first among the
    faulting tenant's own cold placements, then cross-tenant in ascending
    standing, then by the hotness clock; every eviction is CHARGED to the
    tenant whose fault forced it. `pin()` marks a model's placements
    never-victim. The tenant is the request's QoS principal
    (`qos.resolve_principal`, "anonymous" without a request context) and
    the standing `qos.eviction_standing` (token-bucket headroom times
    queue-share headroom).
  * `H2O3_SERVE_HOST_BUDGET_MB` bounds the host tier the same way;
    overflow spills to an npz artifact under ice_root (io/spill.py),
    freed exactly once on release/DELETE/retrain.

With no budget set, placement is eager at acquire and nothing demotes.
The port has no model axis, so the JAX package's `match_partition_rules`
and `shard_params` have no counterpart (parallel/mesh.py): every rank
places one whole copy of each leaf; the families keep declaring
`_partition_rules`.
"""

from __future__ import annotations

import dataclasses
import itertools
import time

import numpy as np
import torch

from h2o3_tpu_torch.analysis.lockdep import make_lock
from h2o3_tpu_torch.obs import metrics as _om
from h2o3_tpu_torch.parallel import mesh as _mesh
from h2o3_tpu_torch.utils.env import env_float

# tier names (string-compatible with core.tiering's ladder)
TIER_HBM = "hbm"
TIER_HOST = "host"
TIER_DISK = "disk"
_TIERS = (TIER_HBM, TIER_HOST, TIER_DISK)

PARAM_BYTES = _om.gauge(
    "h2o3_scorer_params_bytes",
    "HBM-resident bytes of ONE shared serving-param copy per model "
    "(constant in the number of row-bucket programs; demoted "
    "placements leave the gauge — it is bounded by "
    "H2O3_SERVE_HBM_BUDGET_MB when set)")
PLACEMENTS = _om.counter(
    "h2o3_scorer_param_placements_total",
    "serving param pytrees placed on the card (one per model generation)")
PARAM_FAULTS = _om.counter(
    "h2o3_serve_param_faults_total",
    "model-param promotions into HBM by source tier — a cold model "
    "faulting in from its host mirror or ice_root npz artifact")
PARAM_EVICTIONS = _om.counter(
    "h2o3_serve_param_evictions_total",
    "model-param demotions by destination tier, charged to the tenant "
    "whose cold fault forced the eviction")


def _hbm_budget_bytes() -> int:
    """H2O3_SERVE_HBM_BUDGET_MB — byte budget for DEVICE-resident model
    params (0 = unbudgeted eager placement). Read per call so tests and
    operators can retune without a restart. The JAX package reads whole
    MB; the port also takes a fraction (a model's params are often far
    below 1 MB), and a whole number reads as there."""
    return int(env_float("H2O3_SERVE_HBM_BUDGET_MB", 0.0) * (1 << 20))


def _host_budget_bytes() -> int:
    """H2O3_SERVE_HOST_BUDGET_MB — byte budget for the host tier of
    demoted model params (0 = unbounded host tier); a fraction as
    above."""
    return int(env_float("H2O3_SERVE_HOST_BUDGET_MB", 0.0) * (1 << 20))


def _standing(principal: str) -> float:
    """Cross-tenant victim ordering key — qos.eviction_standing in
    [0, 1], lower = heavier consumer = evicted first. Looked up OUTSIDE
    the store lock (qos takes its own locks)."""
    try:
        from h2o3_tpu_torch.serving import qos as _qos
        return _qos.eviction_standing(principal)
    except Exception:   # noqa: BLE001 — victim order must never fail
        return 1.0


# ---------------------------------------------------------------------------
# A minimal pytree: the leaves of a param export are tensors and numeric
# numpy arrays (or scalars); dicts, lists, tuples and dataclasses nest
# them; anything else (ints, strings, None) is static structure.
def _is_leaf(x) -> bool:
    if torch.is_tensor(x):
        return True
    if isinstance(x, (np.ndarray, np.generic)):
        return np.asarray(x).dtype.kind in "biuf"
    return False


def tree_flatten(obj):
    """(leaves, treedef) of a param pytree, leaves in a fixed order."""
    leaves: list = []

    def walk(x):
        if _is_leaf(x):
            leaves.append(x)
            return ("leaf",)
        if isinstance(x, dict):
            keys = tuple(x)
            return ("dict", keys, tuple(walk(x[k]) for k in keys))
        if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
            return (type(x).__name__, tuple(walk(v) for v in x))
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            names = tuple(f.name for f in dataclasses.fields(x))
            return ("dc", type(x), names,
                    tuple(walk(getattr(x, n)) for n in names))
        return ("static", x)

    return leaves, walk(obj)


def tree_unflatten(treedef, leaves):
    it = iter(leaves)

    def build(d):
        kind = d[0]
        if kind == "leaf":
            return next(it)
        if kind == "dict":
            return {k: build(c) for k, c in zip(d[1], d[2])}
        if kind == "list":
            return [build(c) for c in d[1]]
        if kind == "tuple":
            return tuple(build(c) for c in d[1])
        if kind == "dc":
            return d[1](**{n: build(c) for n, c in zip(d[2], d[3])})
        return d[1]

    return build(treedef)


def _leaf_tensor(x) -> torch.Tensor:
    return x.detach() if torch.is_tensor(x) \
        else torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _nbytes(leaves) -> int:
    return int(sum(t.numel() * t.element_size() for t in leaves))


def _to_device(leaves, device) -> list:
    """Fresh device copies (the placement owns its storage), dtypes kept;
    from pinned host leaves the copies are asynchronous."""
    return [t.to(device, copy=True, non_blocking=t.is_pinned())
            for t in leaves]


def _to_host(leaves, device) -> list:
    """Host copies of placed leaves; pinned when the cloud is a card."""
    out = []
    for t in leaves:
        h = t.detach().to("cpu", copy=True)
        if device.type == "cuda":
            h = h.pin_memory()
        out.append(h)
    return out


class Placement:
    """One model generation's params, resident on exactly the tiers its
    non-None slots say: `placed` (device pytree), `host` (flat host
    leaves), `path` (npz spill artifact). `treedef` is the param tree's
    structure; `gen` counts the promotions (a graph captured at another
    gen reads freed storage); `tenant` is the principal that faulted it
    in last; `last` is the hotness-clock tick. `_io` is the per-placement
    transfer lock (one lockdep class), ordered BEFORE the store lock
    exactly like tiering.io → tiering.residency."""

    __slots__ = ("key", "placed", "host", "treedef", "path", "nbytes",
                 "gen", "device", "refs", "tenant", "last", "_io", "_acct")

    def __init__(self, placed, nbytes, host=None, treedef=None):
        self.key = None
        self.placed = placed
        self.host = host
        self.treedef = treedef
        self.path = None
        self.nbytes = nbytes
        self.gen = 0
        self.device = _mesh.cloud().device
        self.refs = 0
        self.tenant = "anonymous"
        self.last = 0
        self._io = make_lock("serving.params.io")
        self._acct = None

    @property
    def tier(self) -> str:
        """Best (fastest) tier this placement is resident on."""
        if self.placed is not None:
            return TIER_HBM
        if self.host is not None:
            return TIER_HOST
        return TIER_DISK


class ParamStore:
    """(model key, generation token) → refcounted, TIERED Placement."""

    def __init__(self):
        self._lock = make_lock("serving.params")
        self._placements: dict = {}
        self._pinned: set = set()
        self._bytes = {t: 0 for t in _TIERS}
        self._reserved = 0
        self._peak_hbm = 0
        self._ticks = itertools.count(1)
        self._fault_count = 0
        self._evictions_by_tenant: dict = {}

    # -- tenancy / clocks --------------------------------------------------
    @property
    def tiering_active(self) -> bool:
        return bool(_hbm_budget_bytes() or _host_budget_bytes())

    def _tick(self) -> int:
        return next(self._ticks)

    @staticmethod
    def _tenant() -> str:
        """The QoS principal of the request on this thread — the tenant
        a fault's evictions are charged to. Never called with the store
        lock held (qos/tracing take their own locks)."""
        try:
            from h2o3_tpu_torch.obs import tracing as _tracing
            from h2o3_tpu_torch.serving import qos as _qos
            return _qos.resolve_principal(_tracing.principal() or "")
        except Exception:   # noqa: BLE001 — attribution must not break serving
            return "anonymous"

    # -- accounting (presence-based, mirrors ChunkPager) -------------------
    def _account_locked(self, p: "Placement"):
        present = (p.placed is not None, p.host is not None,
                   p.path is not None)
        prev = p._acct
        if prev is not None:
            for t, had in zip(_TIERS, prev):
                if had:
                    self._bytes[t] -= p.nbytes
        p._acct = present
        for t, has in zip(_TIERS, present):
            if has:
                self._bytes[t] += p.nbytes
        if present[0] and self._bytes[TIER_HBM] > self._peak_hbm:
            # h2o3-ok: R003 _locked helper — every caller holds self._lock
            self._peak_hbm = self._bytes[TIER_HBM]
        self._gauge_locked(p.key[0])

    def _gauge_locked(self, model_key: str):
        total = sum(pp.nbytes for (mk, _t), pp in self._placements.items()
                    if mk == model_key and pp.placed is not None)
        PARAM_BYTES.set(total, model=model_key)

    def _forget_locked(self, p: "Placement"):
        # Un-account a placement leaving the store. Its in-memory leaves
        # stay intact for in-flight holders, but the DISK artifact is
        # owned by the store and freed exactly once: the path is popped
        # here and unlinked by the caller outside the lock.
        prev = p._acct
        if prev is not None:
            for t, had in zip(_TIERS, prev):
                if had:
                    self._bytes[t] -= p.nbytes
        p._acct = None
        path, p.path = p.path, None
        return path

    def _registered_locked(self, p: "Placement") -> bool:
        return p.key is not None and self._placements.get(p.key) is p

    # -- admission (in-flight reservation discipline) ----------------------
    def _try_reserve(self, nbytes: int, force: bool = False) -> bool:
        """Reserve HBM headroom BEFORE any copy lands — resident +
        reserved never exceeds the budget. `force` admits unconditionally
        (nothing left to demote — correctness over budget, exactly like
        the chunk pager)."""
        with self._lock:
            budget = _hbm_budget_bytes()
            if (force or not budget or
                    self._bytes[TIER_HBM] + self._reserved + nbytes
                    <= budget):
                self._reserved += nbytes
                return True
        return False

    def _release_reservation(self, nbytes: int):
        with self._lock:
            self._reserved -= nbytes

    # -- victim selection / eviction ---------------------------------------
    def _victim(self, tenant: str, exclude=None):
        """The next placement to demote for `tenant`'s fault: same-tenant
        cold placements first, then other tenants in ascending standing,
        then coldest by the hotness clock."""
        with self._lock:
            cands = [(p, p.tenant, p.last)
                     for k, p in self._placements.items()
                     if p.placed is not None and p is not exclude
                     and k[0] not in self._pinned]
        if not cands:
            return None

        def order(item):
            _p, owner, last = item
            if owner == tenant:
                return (0, 0.0, last)
            return (1, _standing(owner), last)
        cands.sort(key=order)
        return cands[0][0]

    def _make_room(self, incoming: int, tenant: str, exclude=None) -> bool:
        """Demote victims until `incoming` bytes fit under the HBM
        budget. False = nothing demotable (caller force-admits)."""
        budget = _hbm_budget_bytes()
        if not budget:
            return True
        while True:
            with self._lock:
                if (self._bytes[TIER_HBM] + self._reserved + incoming
                        <= budget):
                    return True
            vic = self._victim(tenant, exclude)
            if vic is None:
                with self._lock:
                    in_flight = self._reserved
                if not in_flight:
                    return False
                # another fault's reservation holds the room: its
                # placement becomes a victim (or frees the room) when it
                # commits. The JAX package force-admits here, and
                # concurrent faults can then pass the budget.
                time.sleep(1e-4)
                continue
            self.demote(vic, charge=tenant)

    def demote(self, p: "Placement", charge: str | None = None,
               to_tier: str = TIER_HOST):
        """The DEMOTE primitive: copy the placed leaves to (pinned) host
        tensors, drop the device copy; `to_tier="disk"` additionally
        spills the host leaves to an npz artifact under ice_root. The
        eviction is charged to the tenant whose fault forced it."""
        tenant = charge if charge is not None else self._tenant()
        moved = False
        with p._io:
            if p.placed is not None:
                host = p.host
                if host is None:
                    leaves, _ = tree_flatten(p.placed)
                    host = _to_host(leaves, _mesh.cloud().device)
                with self._lock:
                    p.host = host
                    p.placed = None
                    if self._registered_locked(p):
                        self._account_locked(p)
                moved = True
            if (to_tier == TIER_DISK and p.host is not None
                    and p.placed is None and p.path is None):
                from h2o3_tpu_torch.io import spill as _spill
                mk, tok = p.key if p.key is not None else ("params", 0)
                path = _spill.write_params(
                    f"{mk}@{tok}", [t.numpy() for t in p.host])
                with self._lock:
                    p.path = path
                    p.host = None
                    if self._registered_locked(p):
                        self._account_locked(p)
                moved = True
        if moved:
            PARAM_EVICTIONS.inc(tier=to_tier, tenant=tenant)
            with self._lock:
                self._evictions_by_tenant[tenant] = \
                    self._evictions_by_tenant.get(tenant, 0) + 1

    def _spill_host_tier(self, tenant: str):
        """Enforce the host-tier budget after a fault/demote grew it:
        HBM-resident placements drop their host mirror first (free to
        reconstruct), then cold placements spill to disk, coldest
        first."""
        budget = _host_budget_bytes()
        if not budget:
            return
        while True:
            with self._lock:
                if self._bytes[TIER_HOST] <= budget:
                    return
                cands = [p for k, p in self._placements.items()
                         if p.host is not None and k[0] not in self._pinned]
                cands.sort(key=lambda pp: pp.last)
                vic = cands[0] if cands else None
            if vic is None:
                return
            if vic.placed is not None:
                with vic._io:
                    with self._lock:
                        if vic.placed is not None and vic.host is not None:
                            vic.host = None
                            if self._registered_locked(vic):
                                self._account_locked(vic)
            else:
                self.demote(vic, charge=tenant, to_tier=TIER_DISK)

    # -- promotion (fault) -------------------------------------------------
    def fault(self, p: "Placement"):
        """The PROMOTE primitive: place the host leaves (read back from
        their npz artifact first when disk-resident), with admission
        reserved atomically BEFORE the copy starts. Mirrors
        ChunkPager.fault: reserve → copy → account under the lock →
        release the reservation; on a full card, demote victims and
        retry, force-admitting only when nothing is left to demote."""
        tenant = self._tenant()
        src = p.tier
        forced = False
        while True:
            with p._io:
                if p.placed is not None:
                    placed = p.placed
                    with self._lock:
                        p.last = self._tick()
                    return placed
                # h2o3-ok: R022 the commit CONVERTS the reservation to accounted bytes (self._reserved -= nbytes, reserved=False) inside its critical section; the finally releases it on every other path
                if self._try_reserve(p.nbytes, force=forced):
                    stale_path = None
                    reserved = True
                    try:
                        host = p.host
                        dev = _mesh.cloud().device
                        if host is None:
                            from h2o3_tpu_torch.io import spill as _spill
                            host = [torch.from_numpy(a)
                                    for a in _spill.read_params(p.path)]
                            if dev.type == "cuda":
                                host = [t.pin_memory() for t in host]
                        placed = tree_unflatten(p.treedef,
                                                _to_device(host, dev))
                        with self._lock:
                            p.placed = placed
                            p.gen += 1
                            p.device = dev
                            p.host = host if self.tiering_active else None
                            stale_path, p.path = p.path, None
                            p.last = self._tick()
                            p.tenant = tenant
                            self._fault_count += 1
                            if self._registered_locked(p):
                                self._account_locked(p)
                            # convert the reservation to accounted bytes
                            # IN the commit's critical section, so
                            # admitted_bytes() never double-counts an
                            # in-flight fault at any observable instant
                            self._reserved -= p.nbytes
                            reserved = False
                    finally:
                        if reserved:
                            self._release_reservation(p.nbytes)
                    if stale_path is not None:
                        from h2o3_tpu_torch.io import spill as _spill
                        _spill.delete_params(stale_path)
                    break
            forced = not self._make_room(p.nbytes, tenant, exclude=p)
        if src != TIER_HBM:
            PARAM_FAULTS.inc(tier=src)
        self._spill_host_tier(tenant)
        return placed

    # -- placement ---------------------------------------------------------
    def _build_placement(self, model):
        """Compute a Placement WITHOUT the store lock held. Returns None
        for families without a param export. Under a budget the build
        stops at the HOST leaves, so the first device placement goes
        through the same reserved admission as any cold fault."""
        params = model._serving_params()
        if params is None:
            return None
        leaves, treedef = tree_flatten(params)
        leaves = [_leaf_tensor(x) for x in leaves]
        dev = _mesh.cloud().device
        if not self.tiering_active:
            placed = tree_unflatten(treedef, _to_device(leaves, dev))
            return Placement(placed, _nbytes(leaves), treedef=treedef)
        return Placement(None, _nbytes(leaves),
                         host=_to_host(leaves, dev), treedef=treedef)

    def _publish(self, key, p: "Placement") -> "Placement":
        """Install a freshly built Placement under the lock; a racing
        builder's copy loses to the first publish. Returns the placement
        now in the store."""
        tenant = self._tenant()
        with self._lock:
            cur = self._placements.get(key)
            if cur is not None:
                return cur
            p.key = key
            p.tenant = tenant
            p.last = self._tick()
            self._placements[key] = p
            PLACEMENTS.inc()
            self._account_locked(p)
        return p

    def acquire(self, model, token: int):
        """Place (or re-reference) the model's params; bumps the
        refcount. Called once per cache-entry build; each resident bucket
        program holds exactly one reference. Returns the Placement, or
        None for families without a param export."""
        key = (model.key, token)
        with self._lock:
            p = self._placements.get(key)
            if p is not None:
                p.refs += 1
                p.last = self._tick()
                return p
        built = self._build_placement(model)        # outside the lock
        if built is None:
            return None
        p = self._publish(key, built)
        if p.placed is None:
            self.fault(p)
        with self._lock:
            p.refs += 1
        return p

    def reattach(self, model_key: str, token: int, p: "Placement"):
        """Re-install a placement an in-flight build acquired but a
        concurrent invalidate_key swept before the entry published."""
        with self._lock:
            if (model_key, token) not in self._placements:
                p.key = (model_key, token)
                self._placements[(model_key, token)] = p
                self._account_locked(p)

    def placed_ex(self, model, token: int):
        """(placed pytree, Placement, gen) for a dispatch — faulting the
        placement back into HBM first when it was demoted. Does not
        change the refcount; the calling cache entry already holds one.
        When the placement is gone (the entry was invalidated while a
        dispatch was in flight), returns a ONE-SHOT placement that is
        never stored, with Placement None: a program runs it eagerly and
        never captures against it."""
        key = (model.key, token)
        dev = _mesh.cloud().device
        with self._lock:
            p = self._placements.get(key)
            if p is not None:
                p.last = self._tick()
                if p.placed is not None and p.device == dev:
                    return p.placed, p, p.gen
        if p is None or (p.placed is None and p.host is None
                         and p.path is None):
            params = model._serving_params()
            if params is None:
                return None, None, 0
            leaves, treedef = tree_flatten(params)
            return (tree_unflatten(treedef, _to_device(
                [_leaf_tensor(x) for x in leaves], _mesh.cloud().device)),
                None, 0)
        if p.placed is not None and p.device != dev:
            # the cloud moved to another device (init(device=...)): the
            # JAX package's epoch re-place — demote off the old device,
            # fault onto the new one, bit for bit
            self.demote(p, charge=self._tenant())
        while True:
            placed = self.fault(p)
            with self._lock:
                # a concurrent demote between the commit and here leaves
                # p.placed None: fault again
                if p.placed is placed:
                    return placed, p, p.gen

    def placed(self, model, token: int):
        """The CURRENT placed pytree for a dispatch (see placed_ex)."""
        return self.placed_ex(model, token)[0]

    # -- pinning / explicit tier moves -------------------------------------
    def pin(self, model_key: str, on: bool = True):
        """Pin (or unpin) a model's placements against eviction. Pinned
        placements still count against the budget; they are simply never
        victims."""
        with self._lock:
            if on:
                self._pinned.add(model_key)
            else:
                self._pinned.discard(model_key)

    def demote_key(self, model_key: str, to_tier: str = TIER_HOST):
        """Demote every device-resident placement of a model (tests and
        operator tooling)."""
        with self._lock:
            ps = [p for k, p in self._placements.items()
                  if k[0] == model_key]
        for p in ps:
            self.demote(p, to_tier=to_tier)

    # -- release -----------------------------------------------------------
    def release(self, model_key: str, token: int):
        """One cache entry dropped its reference; the LAST release frees
        the placement — every tier, exactly once (the npz artifact is
        unlinked outside the lock; device/host tensors free by GC)."""
        path = None
        with self._lock:
            p = self._placements.get((model_key, token))
            if p is None:
                return
            p.refs -= 1
            if p.refs <= 0:
                del self._placements[(model_key, token)]
                path = self._forget_locked(p)
                if not any(k[0] == model_key for k in self._placements):
                    PARAM_BYTES.remove(model=model_key)
                else:
                    self._gauge_locked(model_key)
        if path is not None:
            from h2o3_tpu_torch.io import spill as _spill
            _spill.delete_params(path)

    def invalidate_key(self, model_key: str):
        """Model DELETE / retrain purge: drop every generation's
        placement for the DKV key regardless of refcount, freeing all
        tiers exactly once."""
        paths = []
        with self._lock:
            for k in [k for k in self._placements if k[0] == model_key]:
                p = self._placements.pop(k)
                path = self._forget_locked(p)
                if path is not None:
                    paths.append(path)
            self._pinned.discard(model_key)
            PARAM_BYTES.remove(model=model_key)
        from h2o3_tpu_torch.io import spill as _spill
        for path in paths:
            _spill.delete_params(path)

    def clear(self):
        paths = []
        with self._lock:
            keys = {k[0] for k in self._placements}
            for p in self._placements.values():
                path = self._forget_locked(p)
                if path is not None:
                    paths.append(path)
            self._placements.clear()
            self._pinned.clear()
            for mk in keys:
                PARAM_BYTES.remove(model=mk)
        from h2o3_tpu_torch.io import spill as _spill
        for path in paths:
            _spill.delete_params(path)

    # -- introspection -----------------------------------------------------
    def bytes_for(self, model_key: str) -> int:
        """Logical bytes of the model's placements across all tiers."""
        with self._lock:
            return sum(p.nbytes for k, p in self._placements.items()
                       if k[0] == model_key)

    def total_bytes(self) -> int:
        with self._lock:
            return sum(p.nbytes for p in self._placements.values())

    def by_model(self) -> dict:
        """{model_key: placement bytes} across resident generations."""
        with self._lock:
            out: dict = {}
            for (mk, _tok), p in self._placements.items():
                out[mk] = out.get(mk, 0) + p.nbytes
            return out

    def by_model_tier(self) -> dict:
        """{model_key: {tier: bytes}} — which rung of the ladder each
        model's generations sit on."""
        with self._lock:
            out: dict = {}
            for (mk, _tok), p in self._placements.items():
                d = out.setdefault(mk, {t: 0 for t in _TIERS})
                d[p.tier] += p.nbytes
            return out

    def resident(self) -> int:
        with self._lock:
            return len(self._placements)

    def hbm_bytes(self) -> int:
        with self._lock:
            return self._bytes[TIER_HBM]

    def reserved_bytes(self) -> int:
        with self._lock:
            return self._reserved

    def admitted_bytes(self) -> int:
        """Resident + in-flight-reserved HBM bytes in ONE lock hold — the
        quantity the admission check bounds; ≤ budget at every instant."""
        with self._lock:
            return self._bytes[TIER_HBM] + self._reserved

    def tier_bytes(self) -> dict:
        with self._lock:
            return dict(self._bytes)

    def peak_hbm_bytes(self) -> int:
        with self._lock:
            return self._peak_hbm

    def reset_peak(self):
        with self._lock:
            self._peak_hbm = self._bytes[TIER_HBM]

    def stats(self) -> dict:
        with self._lock:
            return {
                "tier_bytes": dict(self._bytes),
                "reserved": self._reserved,
                "hbm_budget": _hbm_budget_bytes(),
                "host_budget": _host_budget_bytes(),
                "peak_hbm_bytes": self._peak_hbm,
                "faults": self._fault_count,
                "resident": len(self._placements),
                "pinned": sorted(self._pinned),
                "evictions_by_tenant": dict(self._evictions_by_tenant),
            }


PARAMS = ParamStore()

_om.gauge("h2o3_scorer_param_models",
          "model generations with a live shared serving-param placement",
          fn=lambda: float(PARAMS.resident()))


def _param_tier_series():
    return [({"tier": t}, float(b))
            for t, b in sorted(PARAMS.tier_bytes().items())]


_om.gauge("h2o3_serve_param_tier_bytes",
          "resident model-param bytes per tier of the serving ladder "
          "(hbm / host / disk)",
          fn=_param_tier_series)
