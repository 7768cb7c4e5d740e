#!/usr/bin/env python3
"""The unsharded decode (``TransformerLM.forward_one`` over a ``KVCache``)
against the rank mode on a one-rank mesh (``TransformerLM.decode_ranks``
over a ``RankKVCache`` of one rank), to decide whether ``LMGenerator``
needs both.

Run from the root of a checkout: ``python3 decode_fork_timing.py`` (the
CUDA card, the flagship LM: vocab 256, d 2048, 16 heads, 8 layers, bf16,
B 8, a 2048-token prompt) or ``python3 decode_fork_timing.py --device cpu
--small`` (a tiny LM, to check that the script runs). For the bf16 cache
and the int8 cache it builds both generators on the same weights (seed 0),
checks that their teacher-forced logits over the prompt and 8 more tokens
agree (within 2e-2 of max|logit|, the bf16 band of ``chip_smoke.py``'s
decode checks), then times them in turns, ``--rounds`` times: the prefill
and the decode slope (ms a token between 4 and 16 generated tokens), each
on the host clock ended by a synchronize. It prints one JSON object a cache
with every reading and the medians, and the card's name and power limit
(``nvidia-smi``) beside them. It exits non-zero without a card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch

FLAGSHIP = dict(vocab=256, d_model=2048, n_heads=16, n_layers=8)
SMALL = dict(vocab=32, d_model=64, n_heads=4, n_layers=2)
TF, LO, HI = 8, 4, 16
TOL = 2e-2


def main(argv=None) -> int:
    p = argparse.ArgumentParser("decode_fork_timing")
    p.add_argument("--device", default="cuda")
    p.add_argument("--small", action="store_true")
    p.add_argument("--rounds", type=int, default=5)
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("decode_fork_timing: no CUDA card is visible", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    from akka_allreduce_tpu_torch.models import LMGenerator, SyntheticCopyLM, TransformerLM
    from akka_allreduce_tpu_torch.parallel import RankMesh

    class OneRank(LMGenerator):
        """The generator on a one-rank (model,) mesh, made to decode
        through the rank mode (a mesh of one rank decodes unsharded)."""

        def __init__(self, model, max_len, cache_quant):
            super().__init__(model, max_len, cache_quant,
                             mesh=RankMesh(("model",), (1,), model.embedding.device))
            self.sharded = True

    cfg, batch, prompt_len = (SMALL, 2, 64) if args.small else (FLAGSHIP, 8, 2048)
    max_len = prompt_len + 32

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def timed(fn) -> float:
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        return time.perf_counter() - t0

    def teacher_forced(gen, tokens):
        cache, params = gen.init_cache(batch), gen.place_params()
        out = [gen.step(cache, tokens[:, :prompt_len], params=params)]
        for i in range(prompt_len, tokens.shape[1]):
            out.append(gen.step(cache, tokens[:, i:i + 1], params=params))
        return torch.cat(out, dim=1)

    x, _ = next(SyntheticCopyLM(max_len, vocab=cfg["vocab"], seed=0).batches(batch, 1))
    tokens = torch.from_numpy(x[:, :prompt_len + TF]).to(dev)
    prompt = tokens[:, :prompt_len]
    model = TransformerLM(**cfg, compute_dtype=torch.bfloat16, seed=0, device=dev)
    card = "cpu"
    if dev.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip()
    for quant in (None, "int8"):
        gens = {"forward_one": LMGenerator(model, max_len, quant),
                "one_rank_decode_ranks": OneRank(model, max_len, quant)}
        want = teacher_forced(gens["forward_one"], tokens)
        got = teacher_forced(gens["one_rank_decode_ranks"], tokens)
        err = float((got - want).abs().max() / want.abs().max())
        if not err <= TOL:
            print(f"decode_fork_timing: the one-rank logits are {err} of max|logit| from "
                  "the unsharded decode's", file=sys.stderr)
            return 1
        for g in gens.values():
            g.generate(prompt, LO)  # warm-up
        readings = {name: {"prefill_ms": [], "ms_per_token": []} for name in gens}
        for _ in range(args.rounds):
            for name, g in gens.items():
                slope = (timed(lambda: g.generate(prompt, HI))
                         - timed(lambda: g.generate(prompt, LO))) / (HI - LO) * 1e3
                cache = g.init_cache(batch)
                prefill = timed(lambda: g.step(cache, prompt)) * 1e3
                readings[name]["ms_per_token"].append(slope)
                readings[name]["prefill_ms"].append(prefill)
        rec = {"cache": quant or "bf16", "logits_err_of_max": err, "card": card,
               "shape": dict(cfg, batch=batch, prompt=prompt_len)}
        for name, r in readings.items():
            rec[name] = {**{f"{k}_median": statistics.median(v) for k, v in r.items()}, **r}
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
