#!/usr/bin/env python3
"""Two CPU readings of the ResNet's f32 numerics, the port's
(``akka_allreduce_tpu_torch``) beside the JAX package's. It runs on the CPU
only and is no part of the port.

``python3 resnet_numerics.py gradient`` takes the narrow
``ResNet(stage_sizes=(1, 1, 1, 1), width=8, classes=10)`` of
``tests/test_torch_resnet.py`` at the JAX init and the first ``imagenet_like``
batch of 16 rows at 64 px, and prints, relative to max|g| of the f64
gradient (the JAX model in f64): the distance of the f32 gradient of the
mean loss taken by JAX jitted, by JAX op by op, and by the port; the
distances between JAX's jitted and op-by-op f32 gradients and between the
port's and JAX's jitted ones; and each ReLU input whose sign differs between
JAX's f32 and f64 forwards.

``python3 resnet_numerics.py steps`` runs that model's two ``DPTrainer``
steps of the test (lr 0.1, the second with rank 7 masked) fused
(``bucket_size=262,144``) and overlapped, in JAX and in the port, all from
JAX's init, and prints the max abs distance of each pair's parameters and
losses after the two steps.

``python3 resnet_numerics.py lr`` runs three ``DPTrainer`` steps of
``ResNet50(1000)`` over 8 ranks, ``bucket_size=262,144``, on one batch of 16
``imagenet_like`` rows at 64 px (seed 0; rank 7 masked in the second step),
from the port's seed-0 weights, at lr 0.1 and 0.01, in JAX and in the port,
and prints each run's three losses: the steps ``chip_smoke.py`` takes on the
card.
"""

from __future__ import annotations

import os
import sys
import types

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import jax  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

NARROW = dict(stage_sizes=(1, 1, 1, 1), width=8, classes=10)


def gradient() -> None:
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import torch.nn.functional as F
    from jax.flatten_util import ravel_pytree

    from akka_allreduce_tpu.models import data as jdata
    from akka_allreduce_tpu.models.resnet import ResNet as JResNet
    from akka_allreduce_tpu_torch.binder.api import leaf_order
    from akka_allreduce_tpu_torch.models import ResNet, resnet_state_dict_from_flax

    x, y = next(iter(jdata.imagenet_like(64, 10).batches(16, 1)))
    m32 = JResNet(**NARROW)
    params = jax.jit(m32.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3), jnp.float32))

    def grad_of(model, p, xs, jit=True):
        def loss(p):
            logits = model.apply(p, xs)
            return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()
        g = (jax.jit if jit else lambda f: f)(jax.grad(loss))(p)
        return np.asarray(ravel_pytree(g)[0], np.float64)

    g_jit = grad_of(m32, params, x)
    with jax.disable_jit():
        g_eager = grad_of(m32, params, x, jit=False)
    m64 = JResNet(**NARROW, compute_dtype=jnp.float64)
    g64 = grad_of(m64, jax.tree_util.tree_map(lambda a: a.astype(jnp.float64), params),
                  x.astype(np.float64))

    tm = ResNet(**NARROW, device="cpu")
    tm.load_state_dict(resnet_state_dict_from_flax(jax.device_get(params)))
    F.cross_entropy(tm(torch.from_numpy(x)), torch.from_numpy(y).long()).backward()
    named = dict(tm.named_parameters())
    g_port = torch.cat([named[n].grad.reshape(-1) for n in leaf_order(tm)]).double().numpy()

    scale = np.abs(g64).max()
    for tag, g in (("JAX f32 jitted", g_jit), ("JAX f32 op by op", g_eager),
                   ("port f32", g_port)):
        print(f"{tag} vs f64: {np.abs(g - g64).max() / scale:.3e} of max|g|")
    print(f"JAX f32 jitted vs op by op: {np.abs(g_jit - g_eager).max() / scale:.3e} of max|g|")
    print(f"port f32 vs JAX f32 jitted: {np.abs(g_port - g_jit).max() / scale:.3e} of max|g|")
    # the GroupNorms whose output goes into a ReLU: the stem's and each
    # block's first two
    _, f32 = m32.apply(params, x, capture_intermediates=True, mutable=["intermediates"])
    _, f64 = m64.apply(jax.tree_util.tree_map(lambda a: a.astype(jnp.float64), params),
                       x.astype(np.float64), capture_intermediates=True,
                       mutable=["intermediates"])
    f32, f64 = f32["intermediates"], f64["intermediates"]
    pairs = [(f32["GroupNorm_0"], f64["GroupNorm_0"], "stem")]
    pairs += [(f32[b][n], f64[b][n], f"{b}/{n}") for b in f32 if b.startswith("Bottleneck")
              for n in ("GroupNorm_0", "GroupNorm_1")]
    for a, b, where in pairs:
        a, b = np.asarray(a["__call__"][0]), np.asarray(b["__call__"][0])
        for i in np.argwhere(np.sign(a) != np.sign(b)):
            print(f"ReLU input of opposite sign in f32 and f64 at {where}{tuple(map(int, i))} "
                  f"(image, row, column, channel): f64 {b[tuple(i)]:.3e}, "
                  f"f32 {a[tuple(i)]:.3e}")

def steps() -> None:
    from akka_allreduce_tpu.models import data as jdata
    from akka_allreduce_tpu.models.resnet import ResNet as JResNet
    from akka_allreduce_tpu.parallel import line_mesh as j_line_mesh
    from akka_allreduce_tpu.train import DPTrainer as JDPTrainer
    from akka_allreduce_tpu_torch.models import ResNet
    from akka_allreduce_tpu_torch.parallel import line_mesh
    from akka_allreduce_tpu_torch.train import DPTrainer

    batches = list(jdata.imagenet_like(64, 10).batches(16, 2))
    mask7 = np.array([1.0] * 7 + [0.0], np.float32)
    model = JResNet(**NARROW)
    runs = {}
    for overlap in (False, True):
        kw = {"overlap": True} if overlap else {"bucket_size": 262_144}
        jt = JDPTrainer(types.SimpleNamespace(init=jax.jit(model.init), apply=model.apply),
                        j_line_mesh(8), example_input=np.zeros((1, 8, 8, 3), np.float32),
                        optimizer=optax.sgd(0.1), **kw)
        init = jt.get_flat_params()
        tt = DPTrainer(ResNet(**NARROW, device="cpu"), line_mesh(8, device="cpu"),
                       learning_rate=0.1, **kw)
        tt.set_flat_params(init)
        for name, t in (("JAX", jt), ("port", tt)):
            hist = [t.train_step(*batches[0]), t.train_step(*batches[1], mask7)]
            runs[name, overlap] = (np.array([m.loss for m in hist]), t.get_flat_params())
    mode = {False: "fused", True: "overlapped"}
    for a, b in ((("JAX", False), ("JAX", True)), (("port", False), ("port", True)),
                 (("port", False), ("JAX", False)), (("port", True), ("JAX", True))):
        (la, pa), (lb, pb) = runs[a], runs[b]
        print(f"{a[0]} {mode[a[1]]} vs {b[0]} {mode[b[1]]}: parameters "
              f"{np.abs(pa - pb).max():.3e} apart (max|param| {np.abs(pb).max():.3f}), "
              f"losses {np.abs(la - lb).max():.3e}")


def lr() -> None:
    from akka_allreduce_tpu.models import ResNet50 as JResNet50
    from akka_allreduce_tpu.parallel import line_mesh as j_line_mesh
    from akka_allreduce_tpu.train import DPTrainer as JDPTrainer
    from akka_allreduce_tpu_torch.binder import flatten_params
    from akka_allreduce_tpu_torch.models import ResNet50, imagenet_like
    from akka_allreduce_tpu_torch.parallel import line_mesh
    from akka_allreduce_tpu_torch.train import DPTrainer

    x, y = next(imagenet_like(64, 1000, seed=0).batches(16, 1))
    mask7 = np.array([1.0] * 7 + [0.0], np.float32)
    init = flatten_params(ResNet50(1000, seed=0, device="cpu"))[0]
    jm = JResNet50(1000)
    for rate in (0.1, 0.01):
        jt = JDPTrainer(types.SimpleNamespace(init=jax.jit(jm.init), apply=jm.apply),
                        j_line_mesh(8), example_input=np.zeros((1, 64, 64, 3), np.float32),
                        optimizer=optax.sgd(rate), bucket_size=262_144)
        jt.set_flat_params(init)
        tt = DPTrainer(ResNet50(1000, seed=0, device="cpu"), line_mesh(8, device="cpu"),
                       learning_rate=rate, bucket_size=262_144)
        for name, t in (("JAX", jt), ("port", tt)):
            losses = [t.train_step(x, y, mask7 if i == 1 else None).loss for i in range(3)]
            print(f"lr {rate} {name}: losses {losses}", flush=True)


if __name__ == "__main__":
    modes = {"gradient": gradient, "steps": steps, "lr": lr}
    if len(sys.argv) != 2 or sys.argv[1] not in modes:
        sys.exit("usage: python3 resnet_numerics.py gradient|steps|lr")
    modes[sys.argv[1]]()
