#!/usr/bin/env python3
"""A CPU reading of the MoE router's first-step dropped fraction at
``bench-mfu --workload moe``'s width, in both packages. It runs on the CPU
only and is no part of the port.

``python3 moe_routing_numerics.py`` builds the MoE LM at the bench's width
(vocab 256, d 2048, 16 heads, 8 experts, top-1, capacity factor 1.25,
T 2048, bf16 compute), its depth cut to ``--layers`` (1) and its batch to
two copy-task rows, from each of ``--seeds`` (10) seeds twice:
with flax's initialisers (the JAX ``MoETransformerLM.init``, truncated
normals) and with the port's own draw (untruncated normals, on the CPU as
``--device cpu`` draws them). On the same tokens it prints the dropped
fraction and the aux loss of each, and of the port's forward over seed 0's
flax weights (``moe_state_dict_from_flax``: the same function, so the same
routing). The port's rows carry the share of assignments the busiest
expert of each layer gets (1/8 when the routing is balanced).

    JAX_PLATFORMS=cpu python3 moe_routing_numerics.py [--layers N] [--seeds S]
"""

from __future__ import annotations

import argparse
import json
import os
import time
from unittest import mock

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from akka_allreduce_tpu.models.transformer import MoETransformerLM as JMoELM  # noqa: E402
from akka_allreduce_tpu_torch.models import (  # noqa: E402
    MoETransformerLM,
    lm_copy_task,
    moe_state_dict_from_flax,
)
from akka_allreduce_tpu_torch.ops import moe as tmoe  # noqa: E402

WIDTH = dict(vocab=256, d_model=2048, n_heads=16, n_experts=8, capacity_factor=1.25,
             router_topk=1)
SEQ, ROWS = 2048, 2


def port_reading(model: MoETransformerLM, tokens: np.ndarray) -> dict:
    """The port's forward, each MoE layer's busiest-expert share recorded
    by a wrapper around its ``route_indices``."""
    shares: list[float] = []
    real = tmoe.route_indices

    def recording(logits, capacity, k=1):
        r = real(logits, capacity, k)
        load = torch.bincount(r.idx.reshape(-1), minlength=logits.shape[-1]).float()
        shares.append(round(float(load.max() / load.sum()), 4))
        return r

    with mock.patch.object(tmoe, "route_indices", recording), torch.no_grad():
        _, aux, dropped = model(torch.from_numpy(tokens))
    return {"dropped": float(dropped), "aux": float(aux), "busiest_expert_share": shares}


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--layers", type=int, default=1)
    p.add_argument("--seeds", type=int, default=10)
    args = p.parse_args()
    seeds = range(args.seeds)
    tokens, _ = next(lm_copy_task(SEQ, vocab=WIDTH["vocab"]).batches(ROWS, 1))
    jm = JMoELM(n_layers=args.layers, compute_dtype=jnp.bfloat16, **WIDTH)
    kw = dict(n_layers=args.layers, compute_dtype=torch.bfloat16, device="cpu", **WIDTH)
    t0 = time.perf_counter()
    init, apply = jax.jit(jm.init), jax.jit(jm.apply)
    rows = {}
    for seed in seeds:
        params = init(jax.random.PRNGKey(seed), jnp.asarray(tokens))
        _, aux, dropped = apply(params, jnp.asarray(tokens))
        rows[f"jax, flax init (seed {seed})"] = {"dropped": float(dropped), "aux": float(aux)}
        if seed == 0:  # the same function: the port over these weights
            tree = jax.tree.map(np.asarray, params)
            model = MoETransformerLM(**kw)
            model.load_state_dict(moe_state_dict_from_flax(tree))
            rows[f"port, flax init (seed {seed})"] = port_reading(model, tokens)
            del tree, model
        del params
    for seed in seeds:
        model = MoETransformerLM(seed=seed, **kw)
        rows[f"port, its own init (seed {seed})"] = port_reading(model, tokens)
    print(json.dumps({"width": {**WIDTH, "seq_len": SEQ, "n_layers": args.layers,
                                "rows": ROWS, "compute_dtype": "bf16"},
                      "seconds": round(time.perf_counter() - t0, 1)}))
    for name, r in rows.items():
        print(json.dumps({"run": name, **r}))


if __name__ == "__main__":
    main()
