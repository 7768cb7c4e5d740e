"""The trainer zoo for workload-resilience drills (RESILIENCE.md "Tier 7"),
the port's copy of the JAX package's ``train/zoo.py``.

One registry of the real trainer families the ``chaos-train`` drill (and
its tests) can put through the elastic cycle: for each family a
rank-count-independent :class:`~akka_allreduce_tpu_torch.train.elastic.ElasticTrainer`
whose inner trainer factory takes a ``compress`` kwarg, so the same wrapper
rides both halves of tier 7:

- **membership re-meshes** (snapshot -> rebuild over the live ranks ->
  restore) driven by the TCP cluster's failure detector, and
- **compress-follows-policy** rebuilds driven by the leader's
  :class:`~akka_allreduce_tpu_torch.protocol.RoundPolicy` wire stamp
  (``ElasticTrainer.apply_policy_wire``).

Shapes are the reference's drill sizes (``MLP(16)`` on ``mnist_like``): the
point is the resilience machinery over the real step functions, not
throughput. A node's ranks are virtual ranks on its device (``device``: the
card unless ``"cpu"``); every f32 step of ``dp`` and ``zero1`` averages its
gradient stack through K1.

Family notes:

- ``dp``: the config-5 workhorse (MLP + ``DPTrainer``, SGD 0.1). Error
  feedback rides every compressed mode, so a policy ladder walk exercises
  the residual carry across factory rebuilds.
- ``zero1``: sharded optimizer state (SGD with momentum 0.9) through the
  rank-count-independent checkpoint protocol. Its reduce-scatter has no int8
  ring, so an ``int8`` stamp degrades to the deepest mode the family has
  (``bf16``) instead of refusing: degrade, not wedge. Its learning rate is
  0.05 where the JAX zoo's is 0.1: with momentum 0.9 (a step of 1.0 in
  effect) the 0.1 setting diverges on the drill's 12-row batches within 300
  steps from some initial weights, in both packages (the JAX zoo's own
  trainer from its seeds 2 and 5, losses past 2e5; this one from seed 0,
  ``chaos-train``'s, past 4e8), which leaves ``chaos-train``'s loss band to
  chance. At 0.05 it holds from every seed 0-5
  (``tests/test_torch_zoo.py``).
- ``fsdp`` and ``pipeline`` keep their names and their rank counts a node,
  but building them raises ``NotImplementedError``: their trainers
  (``FSDPLMTrainer``, ``ElasticPipelineTrainer``) are ROADMAP Queue 1 item 11.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Sequence

__all__ = [
    "FAMILIES",
    "batch_for",
    "dataset_for",
    "devices_per_node",
    "family_param_count",
    "make_elastic",
]

FAMILIES = ("dp", "zero1", "fsdp", "pipeline")

#: virtual ranks each cluster node contributes to the local mesh (pipeline
#: gets 2 so a node loss restages instead of only shrinking dp)
_DEVICES_PER_NODE = {"dp": 1, "zero1": 1, "fsdp": 1, "pipeline": 2}

_HIDDEN = (16,)
_ZERO1_LR = 0.05
_SEQ_LEN = 32
_VOCAB = 16


@dataclasses.dataclass(frozen=True)
class _Family:
    make: Callable  # (devices_by_node, seed, clock, min_nodes, device) -> elastic
    rows: Callable  # live trainer -> global batch rows (re-mesh aware)
    dataset: Callable  # () -> dataset with .batches(rows, steps, seed_offset)


def devices_per_node(family: str) -> int:
    _require(family)
    return _DEVICES_PER_NODE[family]


def _require(family: str) -> None:
    if family not in FAMILIES:
        raise ValueError(f"family must be one of {FAMILIES}, got {family!r}")


def _mnist():
    from akka_allreduce_tpu_torch.models import data

    return data.mnist_like()


def _lm():
    from akka_allreduce_tpu_torch.models import data

    return data.lm_copy_task(_SEQ_LEN, vocab=_VOCAB)


def _make_dp(devices_by_node, seed, clock, min_nodes, device):
    from akka_allreduce_tpu_torch.models import MLP
    from akka_allreduce_tpu_torch.train.elastic import ElasticTrainer
    from akka_allreduce_tpu_torch.train.trainer import DPTrainer

    def factory(mesh, compress=None):
        return DPTrainer(
            MLP(hidden=_HIDDEN, classes=10, seed=seed, device=mesh.device),
            mesh,
            learning_rate=0.1,
            compress=compress,
            # the residual carry is the family's EF story: active under
            # every lossy mode, rebuilt across level changes via Snapshot
            error_feedback=compress is not None,
        )

    return ElasticTrainer(factory, devices_by_node, min_nodes=min_nodes, clock=clock,
                          device=device)


def _make_zero1(devices_by_node, seed, clock, min_nodes, device):
    import torch

    from akka_allreduce_tpu_torch.models import MLP
    from akka_allreduce_tpu_torch.train.elastic import ElasticTrainer
    from akka_allreduce_tpu_torch.train.zero1 import Zero1DPTrainer

    def factory(mesh, compress=None):
        return Zero1DPTrainer(
            MLP(hidden=_HIDDEN, classes=10, seed=seed, device=mesh.device),
            mesh,
            # momentum makes the sharded moments real state: a re-mesh that
            # dropped them would visibly bend the loss curve
            optimizer=lambda params: torch.optim.SGD(params, lr=_ZERO1_LR, momentum=0.9),
            compress=compress,
            error_feedback=compress is not None,
        )

    e = ElasticTrainer(factory, devices_by_node, min_nodes=min_nodes, clock=clock,
                       device=device)
    # ZeRO-1's reduce-scatter has no int8 ring: the deepest stamp degrades
    # to bf16, the family's floor, instead of refusing. The clamp lives on
    # the wrapper so an int8 stamp arriving while already at bf16 is a
    # recognized no-op, not a rebuild of the same trainer.
    e.clamp_compress = lambda mode: "bf16" if mode else None
    return e


def _not_ported(family: str, trainer: str):
    def make(*_args):
        raise NotImplementedError(
            f"the {family} family needs {trainer}, which is not ported yet "
            "(ROADMAP.md Queue 1, item 11)")

    return make


_REGISTRY: dict[str, _Family] = {
    "dp": _Family(make=_make_dp, rows=lambda t: 4 * t.n_devices, dataset=_mnist),
    "zero1": _Family(make=_make_zero1, rows=lambda t: 4 * t.n_devices, dataset=_mnist),
    "fsdp": _Family(make=_not_ported("fsdp", "FSDPLMTrainer"),
                    rows=lambda t: 2 * t.n_devices, dataset=_lm),
    "pipeline": _Family(make=_not_ported("pipeline", "ElasticPipelineTrainer"),
                        rows=lambda t: t.trainer.dp * 2, dataset=_lm),
}


def make_elastic(
    family: str,
    devices_by_node: Mapping[int, Sequence],
    *,
    seed: int = 0,
    clock=None,
    min_nodes: int = 1,
    device=None,
):
    """Build the family's ElasticTrainer over ``devices_by_node`` (node id ->
    its virtual-rank labels), its ranks on ``device`` (the card unless
    ``"cpu"``)."""
    import time

    _require(family)
    return _REGISTRY[family].make(devices_by_node, seed, clock or time.monotonic,
                                  min_nodes, device)


def dataset_for(family: str):
    _require(family)
    return _REGISTRY[family].dataset()


def batch_for(family: str, dataset, elastic, seed_offset: int):
    """One global batch sized for the live trainer (re-mesh aware: the row
    count follows the current rank count)."""
    _require(family)
    rows = _REGISTRY[family].rows(elastic)
    return next(iter(dataset.batches(rows, 1, seed_offset=seed_offset)))


def family_param_count(family: str) -> int:
    """The family model's (rank-count-independent) parameter count, which
    sizes the cluster's ``data_size``. Built over one virtual rank on the
    CPU, so the caller opens no CUDA context."""
    _require(family)
    e = make_elastic(family, {0: [0]}, device="cpu")
    return int(e.trainer.param_count)
