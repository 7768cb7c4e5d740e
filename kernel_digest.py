#!/usr/bin/env python3
"""Digests of K4's kernel outputs on seeded inputs, to show whether two
checkouts' kernels give bit-identical results.

Run from the root of the checkout whose kernels are to be digested, with
this script's path: ``python3 <path>/kernel_digest.py``. It imports the
``akka_allreduce_tpu_torch`` package of the working directory (so the same
script digests an older checkout unpacked elsewhere), builds its K4 kernels,
runs K4's forward and backward on one CUDA card at the listed shapes on
inputs drawn from seed 0, and prints one JSON object: for each shape, the
first 16 hex digits of the SHA-256 of the forward's output and lse, and of
the backward's dq, dk and dv; for f32 also of the backward's dq, dk and dv
on a fixed o and lse (from ``flash_attention_reference``), so that this
digest does not move with the forward, and of that o and lse. Equal digests
on one card mean bit-identical outputs. It exits non-zero without a card.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

import torch

# (dtype, B, T, H, H_kv, D, causal): the flagship in bf16 and f32, and
# shapes with ragged 128-row blocks, grouped-query K/V and D 64 and 256
SHAPES = [
    ("bfloat16", 8, 2048, 16, 16, 128, True),
    ("bfloat16", 1, 1088, 8, 1, 64, True),
    ("bfloat16", 1, 576, 8, 4, 256, False),
    ("float32", 2, 2048, 16, 16, 128, True),
    ("float32", 1, 1088, 8, 1, 64, True),
]


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for x in tensors:
        h.update(x.contiguous().view(-1).view(torch.uint8).cpu().numpy())
    return h.hexdigest()[:16]


def main() -> int:
    sys.path.insert(0, os.getcwd())
    if not torch.cuda.is_available():
        print("kernel_digest: no CUDA card is visible", file=sys.stderr)
        return 1
    from akka_allreduce_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda", 0)
    out = {}
    for dt, b, t, h, h_kv, d, causal in SHAPES:
        dtype = getattr(torch, dt)
        gen = torch.Generator(device=dev).manual_seed(0)
        q = torch.randn((b, t, h, d), generator=gen, device=dev).to(dtype)
        k, v = (torch.randn((b, t, h_kv, d), generator=gen, device=dev).to(dtype)
                for _ in range(2))
        do = torch.randn((b, t, h, d), generator=gen, device=dev).to(dtype)
        o, lse = fa._forward(q, k, v, causal, d ** -0.5)
        grads = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
        torch.cuda.synchronize()
        row = {"forward": digest(o, lse), "backward": digest(*grads)}
        if dt == "float32":
            o, lse = fa.flash_attention_reference(q, k, v, causal=causal,
                                                  return_lse=True)
            grads = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
            torch.cuda.synchronize()
            row.update(fixed_o_lse=digest(o, lse), backward_fixed=digest(*grads))
        out[f"{dt} B{b} T{t} H{h}/{h_kv} D{d} causal={causal}"] = row
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
