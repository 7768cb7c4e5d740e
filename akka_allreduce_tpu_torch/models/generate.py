"""Autoregressive decoding for the Transformer LM family (KV cache).

Counterpart of ``akka_allreduce_tpu/models/generate.py::LMGenerator``, single
device only (``mesh=None``): tensor-parallel and sequence-sharded decode
wait for a later slice.

- Prefill consumes the prompt in one forward over an empty cache, so at a
  gated prompt length every layer's attention runs K4, the flash kernel;
  each further token is one forward of length 1 over the live cache slots
  (the dense path: a (B, H, 1, L) score matrix).
- The cache is one (B, max_len, H_kv, D) tensor per layer and per K and V,
  in the compute dtype, so grouped-query attention shrinks it by H/H_kv;
  its index is a host int. With ``cache_quant="int8"`` the payloads are
  int8 with one f32 scale a (token, head) row, (B, max_len, H_kv): D + 4
  bytes a row of K or of V against D · itemsize (132 against 256 at D 128
  in bf16).
- Sampling is greedy (``temperature=0``) or a categorical draw at a
  temperature from a ``torch.Generator`` seeded with ``seed``. The draw
  cannot reproduce JAX's PRNG; it is deterministic per seed.

The model holds its weights, so the methods take no ``params`` argument.
Numerical oracle (tests): teacher-forcing the decode path over a fixed
sequence reproduces the training forward's logits at every position.
"""

from __future__ import annotations

import torch

from akka_allreduce_tpu_torch.models.transformer import CACHE_QUANTS, KVCache, TransformerLM


class LMGenerator:
    """KV-cache decoder for a :class:`TransformerLM`.

    Args:
      model: the LM, on the device decoding should run on.
      max_len: cache capacity = prompt length + generated tokens budget.
      cache_quant: None (the compute dtype) or "int8" (quantized payloads
        and f32 row scales); anything else raises at the first use, as the
        JAX module raises at its first apply.
      mesh: must be None (single device); sharded decode is not ported yet.
    """

    def __init__(self, model: TransformerLM, max_len: int, cache_quant: str | None = None,
                 mesh: object | None = None) -> None:
        if mesh is not None:
            raise NotImplementedError(
                "sharded decode (mesh) is not ported yet (ROADMAP item 10); use mesh=None"
            )
        if max_len < 1:
            raise ValueError(f"max_len must be >= 1, got {max_len}")
        self.model = model
        self.max_len = max_len
        self.cache_quant = cache_quant

    def init_cache(self, batch: int) -> KVCache:
        """Fresh zero cache for ``batch`` rows: (B, max_len, H_kv, D) per
        layer on the model's device, in its compute dtype or, quantized,
        int8 with (B, max_len, H_kv) f32 scales; index 0."""
        if self.cache_quant not in CACHE_QUANTS:
            raise ValueError(f"cache_quant must be None or 'int8', got {self.cache_quant!r}")
        m = self.model
        dev = m.embedding.device
        shape = (batch, self.max_len, m.n_kv_heads, m.head_dim)
        quant = self.cache_quant == "int8"

        def zeros(shape, dtype):
            return [torch.zeros(shape, dtype=dtype, device=dev) for _ in range(m.n_layers)]

        if not quant:
            return KVCache(zeros(shape, m.compute_dtype), zeros(shape, m.compute_dtype), 0)
        return KVCache(zeros(shape, torch.int8), zeros(shape, torch.int8), 0,
                       k_scale=zeros(shape[:3], torch.float32),
                       v_scale=zeros(shape[:3], torch.float32))

    @torch.no_grad()
    def generate(
        self,
        prompt: torch.Tensor,
        steps: int,
        *,
        temperature: float = 0.0,
        seed: int = 0,
    ) -> torch.Tensor:
        """Generate ``steps`` tokens after ``prompt`` (B, T_prompt); returns
        (B, steps) int32 on the model's device."""
        if prompt.ndim != 2:
            raise ValueError(f"prompt must be (B, T), got {tuple(prompt.shape)}")
        if steps < 1:
            raise ValueError(f"need steps >= 1, got {steps}")
        if prompt.shape[1] + steps > self.max_len:
            raise ValueError(
                f"prompt {prompt.shape[1]} + steps {steps} exceeds "
                f"max_len {self.max_len}"
            )
        dev = self.model.embedding.device
        gen = torch.Generator(device=dev).manual_seed(seed)

        def sample(logits: torch.Tensor) -> torch.Tensor:
            if temperature <= 0.0:
                return torch.argmax(logits, dim=-1)
            probs = torch.softmax(logits / temperature, dim=-1)
            return torch.multinomial(probs, 1, generator=gen)[:, 0]

        cache = self.init_cache(prompt.shape[0])
        # prefill: the whole prompt in one forward fills the cache
        logits = self.model(prompt.to(dev), cache)
        tok = sample(logits[:, -1])
        out = [tok]
        for _ in range(steps - 1):
            logits = self.model(tok[:, None], cache)
            tok = sample(logits[:, -1])
            out.append(tok)
        return torch.stack(out, dim=1).to(torch.int32)

    @torch.no_grad()
    def decode_logits(self, tokens: torch.Tensor, *, chunk: int = 1) -> torch.Tensor:
        """Teacher-forced logits via the cache path: feed ``tokens`` (B, T)
        in ``chunk``-sized pieces and return (B, T, vocab), the oracle hook
        that must equal the training forward's logits."""
        b, t = tokens.shape
        if t % chunk:
            raise ValueError(f"t={t} not divisible by chunk={chunk}")
        cache = self.init_cache(b)
        tokens = tokens.to(self.model.embedding.device)
        outs = [self.model(tokens[:, i:i + chunk], cache) for i in range(0, t, chunk)]
        return torch.cat(outs, dim=1)
