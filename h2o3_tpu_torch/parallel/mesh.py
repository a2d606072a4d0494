"""The "cloud" of the port (h2o3_tpu/parallel/mesh.py).

The JAX package forms a device mesh over every visible chip and row-shards
frames over its "rows" axis. The port's cloud is a world of processes,
one rank each, joined by a `torch.distributed` process group: `init()`
alone forms a world of one on `cuda:0` (`init(device="cpu")` on the CPU,
the tests' way in); `deploy/multihost.bootstrap` forms a world of several
(H2O3_COORDINATOR_ADDRESS) and hands `init` the group, its rank and size.
Every Frame, Vec and estimator reads its device from here, and a frame
of a world of several holds `row_block(nrows)` of the rows on each rank
(contiguous blocks in rank order; no padding rows). Without a CUDA card
`init()` raises; it never carries on quietly on the CPU.

The collectives run over gloo, on the card as on the CPU: the ranks of
one machine may share one card, where NCCL refuses two ranks, and gloo's
all-reduce and broadcast take CUDA tensors (its gathers do not, so
`mrtask.host_fetch` goes through the host).

`note_epoch` follows the elastic membership's epoch (deploy/membership):
a membership change after formation leaves the process group short of a
rank, so the cloud records that its world is broken and every later
collective raises (`WorldBroken`) instead of waiting on a dead peer.
The JAX package's `match_partition_rules`, `shard_params` and
`make_shard_and_gather_fns` place a model's params over a model axis;
the port has none (`-n_model_shards` other than 1 raises), so they have
no counterpart: the serving param store places one whole copy of each
leaf on this rank's device (serving/params.py).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import torch

from h2o3_tpu_torch.core.kvstore import DKV

ROWS = "rows"
MODEL = "model"

_lock = threading.RLock()
_CLOUD: "Cloud | None" = None


class WorldBroken(RuntimeError):
    """A collective was asked of a world that lost a rank after it was
    formed (the elastic layer excised it)."""


@dataclass
class Cloud:
    device: torch.device
    name: str = "h2o3-tpu-torch"
    rank: int = 0
    world: int = 1
    group: object = None         # torch.distributed process group or None
    epoch: int = 1
    broken: str = ""             # why the world can no longer reduce

    @property
    def n_devices(self) -> int:
        return self.world

    @property
    def n_rows_shards(self) -> int:
        return self.world

    @property
    def n_model_shards(self) -> int:
        return 1

    def row_block(self, nrows: int, rank: int | None = None):
        """(lo, hi) of this rank's (or `rank`'s) contiguous block of
        `nrows` global rows: the first nrows % world ranks hold one more."""
        r = self.rank if rank is None else int(rank)
        q, extra = divmod(int(nrows), self.world)
        lo = r * q + min(r, extra)
        return lo, lo + q + (1 if r < extra else 0)

    def describe(self) -> dict:
        """The cloud's census (REST /3/Cloud): its ranks and this rank's
        device, named as torch.cuda.get_device_name gives it on the card."""
        if self.device.type == "cuda":
            name = torch.cuda.get_device_name(self.device)
            platform = "gpu"
        else:
            name = str(self.device)
            platform = "cpu"
        return {
            "cloud_name": self.name,
            "cloud_size": self.n_devices,
            "mesh_shape": {ROWS: self.world, MODEL: 1},
            "devices": [name] * self.world,
            "platform": platform,
            "rank": self.rank,
            "epoch": self.epoch,
            "consensus": "locked",  # formed, and fixed until an epoch bump
        }


def _resolve_device(device) -> torch.device:
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "h2o3_tpu_torch.init(): no CUDA device is available; "
                "pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", 0)
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def init(device: str | torch.device | None = None,
         name: str | None = None, *, rank: int = 0, world: int = 1,
         group=None) -> Cloud:
    """Form the cloud (h2o.init analog). `device=None` means the first CUDA
    card and raises when there is none; pass `device="cpu"` to run on the
    CPU. `rank`, `world` and `group` describe a world of several processes
    (deploy/multihost.bootstrap passes them). Calling it again replaces the
    cloud. Name: explicit arg > ai.h2o.cloud.name property (-name flag) >
    default. The extensions that ai.h2o.extensions names load once the
    cloud is formed."""
    global _CLOUD
    dev = _resolve_device(device)
    if world < 1 or not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}")
    if world > 1 and group is None:
        raise ValueError("a world of several ranks needs its process group")
    if name is None:
        from h2o3_tpu_torch.utils import config as _cfg
        name = str(_cfg.get_property("cloud.name", None) or "h2o3-tpu-torch")
    with _lock:
        _CLOUD = Cloud(device=dev, name=name, rank=int(rank),
                       world=int(world), group=group)
        # extension lifecycle (ExtensionManager onLocalNodeStarted analog)
        try:
            from h2o3_tpu_torch.ext import load_configured_extensions
            load_configured_extensions(_CLOUD)
        except Exception:   # an extension failure must not kill the cloud
            import traceback
            traceback.print_exc()
        return _CLOUD


def cloud() -> Cloud:
    """The formed cloud; forms the default (CUDA) one on first use."""
    c = _CLOUD
    return c if c is not None else init()


def cluster_info() -> dict:
    """REST /3/Cloud analog."""
    return cloud().describe()


def shutdown():
    global _CLOUD
    with _lock:
        DKV.clear()
        _CLOUD = None


def note_epoch(epoch: int) -> Cloud:
    """Adopt a cloud-membership epoch (deploy/membership listener hook).
    Past the formed world's epoch, a world of several ranks has lost or
    replaced a member its process group was formed with: the cloud keeps
    serving what needs no collective (scoring is local to a rank) and
    marks the world broken, so the next collective raises WorldBroken
    instead of waiting on a peer that is gone. Idempotent for old or
    equal epochs."""
    global _CLOUD
    with _lock:
        c = cloud()
        if epoch <= c.epoch:
            return c
        broken = c.broken
        if c.world > 1 and not broken:
            broken = (f"the world of {c.world} ranks formed at epoch "
                      f"{c.epoch} changed membership (epoch {epoch}); "
                      "collectives need the cloud formed again")
        _CLOUD = Cloud(device=c.device, name=c.name, rank=c.rank,
                       world=c.world, group=c.group, epoch=int(epoch),
                       broken=broken)
        return _CLOUD
