"""Entry points of the port, mirroring ``__graft_entry__.py`` at the repo root.

- ``entry()`` — the flagship model's forward (ResNet-50, 1000 classes, the
  BASELINE config 4 workload) on ``(4, 64, 64, 3)`` f32 images, on the card:
  returns ``(fn, args)`` with ``fn(*args)`` the logits.
- ``dryrun_multichip(n)`` — one full data-parallel training step over n
  virtual ranks (a 2D butterfly grid when n > 2 and even, else a line), a
  step with the last rank masked, every ``threshold_allreduce`` schedule and
  the compressed ones against the masked-mean oracle, and a 2-step
  ``train_chain``. The JAX function goes on to the ZeRO-1, FSDP, sequence-,
  tensor-, expert- and pipeline-parallel trainers, the elastic families and
  the sharded decoder; this one stops there (the port's ZeRO-1 is
  ``Zero1DPTrainer``, its sequence and tensor parallelism
  ``LongContextTrainer``; the others are not ported yet).

Both run on the card unless ``device="cpu"`` is given.
"""

from __future__ import annotations

import numpy as np


def entry(device=None):
    """Returns ``(fn, args)``: a ResNet-50 forward, ``fn(params, x)``."""
    import torch
    from torch.func import functional_call

    from akka_allreduce_tpu_torch.models import ResNet50

    model = ResNet50(classes=1000, device=device)
    x = torch.zeros((4, 64, 64, 3), device=next(model.parameters()).device)
    params = dict(model.named_parameters())

    def forward(params, x):
        with torch.no_grad():
            return functional_call(model, params, (x,))

    return forward, (params, x)


def dryrun_multichip(n_devices: int, *, device=None) -> None:
    """One full DP train step over ``n_devices`` virtual ranks, then the
    masked step, the schedules and the chain (see the module docstring)."""
    from akka_allreduce_tpu_torch.comm.allreduce import threshold_allreduce
    from akka_allreduce_tpu_torch.models import MLP, mnist_like
    from akka_allreduce_tpu_torch.parallel import grid_mesh, line_mesh
    from akka_allreduce_tpu_torch.train import DPTrainer

    # 2D butterfly grid when n factors, else a 1D line
    if n_devices > 2 and n_devices % 2 == 0:
        mesh = grid_mesh(n=n_devices, device=device)
    else:
        mesh = line_mesh(n_devices, device=device)
    trainer = DPTrainer(
        MLP(hidden=(32,), classes=10, device=mesh.device),
        mesh,
        learning_rate=0.1,
        bucket_size=4096,  # the bucketed (chunked-buffer) gradient path
    )
    ds = mnist_like()
    x, y = next(iter(ds.batches(2 * n_devices, 1)))
    # step 1: full participation; step 2: the last rank masked out (the
    # threshold fault-tolerance path)
    m1 = trainer.train_step(x, y)
    valid = np.ones((n_devices,), np.float32)
    valid[-1] = 0.0
    x2, y2 = next(iter(ds.batches(2 * n_devices, 1, seed_offset=2)))
    m2 = trainer.train_step(x2, y2, valid)
    assert m1.contributors == float(n_devices), m1
    assert m2.contributors == float(n_devices - 1), m2
    assert np.isfinite(m1.loss) and np.isfinite(m2.loss)
    print(
        f"dryrun_multichip ok: mesh={mesh.shape} "
        f"step1 loss={m1.loss:.4f} ({m1.contributors:.0f} contributors), "
        f"step2 loss={m2.loss:.4f} ({m2.contributors:.0f} contributors)"
    )

    # data-plane schedules: psum / butterfly / ring / the ring kernel all
    # agree with the masked-mean oracle on this mesh
    rng = np.random.default_rng(0)
    xs = rng.standard_normal((n_devices, 4096)).astype(np.float32)
    mask = np.ones((n_devices,), np.float32)
    mask[-1] = 0.0
    lmesh = line_mesh(n_devices, device=mesh.device)
    oracle = (xs * mask[:, None]).sum(0) / mask.sum()
    schedules = ["psum", "ring", "pallas_ring"] + (
        ["butterfly"] if mesh.axis_names == ("rows", "cols") else []
    )
    for sched in schedules:
        res = threshold_allreduce(
            mesh if sched == "butterfly" else lmesh, xs, mask, schedule=sched,
            bucket_size=1024 if sched == "pallas_ring" else None,
        )
        np.testing.assert_allclose(
            res.average().cpu().numpy(), oracle, rtol=1e-4, atol=1e-5
        )
    print(f"dryrun schedules ok: {schedules} (one rank masked)")

    # the butterfly over a (n/2, 2) grid: the hierarchical 2D schedule; at
    # exactly 4 ranks the loop above already ran this (2, 2) grid
    if n_devices > 4 and n_devices % 2 == 0:
        sg = grid_mesh(n_devices // 2, 2, device=mesh.device)
        res = threshold_allreduce(sg, xs, mask, schedule="butterfly")
        np.testing.assert_allclose(
            res.average().cpu().numpy(), oracle, rtol=1e-4, atol=1e-5
        )
        print(f"dryrun slice-grid butterfly ok: rows={n_devices // 2} x cols=2, "
              "one rank masked")

    # compressed wire variants: bf16 (psum + both rings) and int8 (rings)
    # within quantization error
    scale = np.abs(oracle).max() + 1e-6
    for sched, comp, tol in (
        ("psum", "bf16", 2e-2),
        ("ring", "bf16", 2e-2),
        ("pallas_ring", "bf16", 2e-2),
        ("ring", "int8", 8e-2),
        ("pallas_ring", "int8", 8e-2),
    ):
        res = threshold_allreduce(
            lmesh, xs, mask, schedule=sched, compress=comp,
            bucket_size=1024 if sched == "pallas_ring" else None,
        )
        err = np.abs(res.average().cpu().numpy() - oracle).max() / scale
        assert err < tol, (sched, comp, err)
    print("dryrun compressed schedules ok: bf16 psum/ring/pallas_ring, "
          "int8 ring/pallas_ring")

    # the on-device training chain (the data-loader path)
    chain_hist = trainer.train_chain(ds.device_sampler(), steps=2, batch_per_device=2)
    assert len(chain_hist) == 2 and np.isfinite(chain_hist[-1].loss)
    print(f"dryrun train_chain ok: loss={chain_hist[-1].loss:.4f}")


if __name__ == "__main__":
    fn, args = entry()
    print("entry() forward:", tuple(fn(*args).shape))
    dryrun_multichip(8)
