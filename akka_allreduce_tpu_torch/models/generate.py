"""Autoregressive decoding for the Transformer LM family (KV cache).

Counterpart of ``akka_allreduce_tpu/models/generate.py::LMGenerator``, on one
device or over a mesh of virtual ranks:

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
- With a ``mesh`` (a ``parallel.mesh.RankMesh`` with a ``seq`` and/or a
  ``model`` axis, and optionally a replicated ``data`` axis), every rank
  decodes the same tokens on its own share (``TransformerLM.decode_ranks``):
  tensor-parallel over ``model`` (each rank's ``tp_param_specs`` shard of
  the heads and the MLP, its ``H_kv / tp`` cached heads, the psums over
  ``model``), sequence-sharded over ``seq`` (each rank owns ``max_len /
  sp`` contiguous cache slots, a chunk's tokens written into the rank that
  owns each slot, the partial softmaxes merged by ``seq_decode_attention``).
  The cache is a ``RankKVCache`` of rank stacks; the logits are equal on
  every rank. Without a mesh (or on a mesh whose seq and model axes have
  one rank) it decodes through ``TransformerLM.forward_one``: the rank
  mode on one rank gives the same logits, but its prefill took 4-6% longer
  at the flagship on an H100 (``decode_fork_timing.py``).
- Sampling is greedy (``temperature=0``) or a categorical draw at a
  temperature from a ``torch.Generator`` seeded with ``seed``. The draw
  cannot reproduce JAX's PRNG; it is deterministic per seed.

The model holds its weights, so the methods take no ``params`` argument; a
model built with training axes decodes as the generator's mesh says, as the
JAX generator ignores a training configuration's axes. Numerical oracle
(tests): teacher-forcing the decode path over a fixed sequence reproduces
the training forward's logits at every position, and a mesh's logits the
unsharded decode's.
"""

from __future__ import annotations

import torch

from akka_allreduce_tpu_torch.models.transformer import (
    CACHE_QUANTS,
    KVCache,
    RankKVCache,
    TransformerLM,
    tp_param_specs,
)
from akka_allreduce_tpu_torch.parallel.mesh import (
    PartitionSpec,
    RankMesh,
    local_shape,
    rank_unview,
    rank_view,
)

DECODE_AXES = ("data", "seq", "model")


class LMGenerator:
    """KV-cache decoder for a :class:`TransformerLM`.

    Args:
      model: the LM, on the device decoding should run on.
      max_len: cache capacity = prompt length + generated tokens budget;
        divisible by the ``seq`` axis size when sequence-sharding.
      cache_quant: None (the compute dtype) or "int8" (quantized payloads
        and f32 row scales); anything else raises at the first use, as the
        JAX module raises at its first apply.
      mesh: None (one device), or a ``RankMesh`` on the model's device
        whose axes are ``seq`` and/or ``model``, plus an optional
        replicated ``data`` axis (the module docstring).
    """

    def __init__(self, model: TransformerLM, max_len: int, cache_quant: str | None = None,
                 mesh: RankMesh | None = None) -> None:
        if max_len < 1:
            raise ValueError(f"max_len must be >= 1, got {max_len}")
        self.model = model
        self.max_len = max_len
        self.cache_quant = cache_quant
        self.mesh = mesh
        self.tp = self.sp = 1
        if mesh is not None:
            names = tuple(mesh.axis_names)
            if not set(names) <= set(DECODE_AXES) or not {"seq", "model"} & set(names):
                raise ValueError(
                    f"decode mesh needs a 'seq' and/or 'model' axis (plus an optional "
                    f"replicated 'data' axis), got {names}")
            self.tp = mesh.shape.get("model", 1)
            self.sp = mesh.shape.get("seq", 1)
            if model.n_heads % self.tp or model.n_kv_heads % self.tp:
                raise ValueError(
                    f"n_heads={model.n_heads} and n_kv_heads={model.n_kv_heads} must both "
                    f"divide by the model axis size {self.tp} for tensor-parallel decode")
            if max_len % self.sp:
                raise ValueError(
                    f"max_len={max_len} must divide by the seq axis size {self.sp} (each "
                    "shard owns max_len/sp cache slots)")
            if mesh.device != model.embedding.device:
                raise ValueError(f"the mesh is on {mesh.device}, the model on "
                                 f"{model.embedding.device}")
        # a mesh whose seq and model axes have one rank decodes unsharded, as
        # the JAX generator does
        self.sharded = self.tp > 1 or self.sp > 1
        self.seq_axis = "seq" if self.sp > 1 else None
        self.model_axis = "model" if self.tp > 1 else None

    def _cache_spec(self, name: str) -> PartitionSpec:
        """A cache variable's spec over the mesh: the payloads ``k``/``v``
        (B, L, H_kv, D) and the int8 scales ``k_scale``/``v_scale`` (B, L,
        H_kv) shard their slot dim over ``seq`` and their head dim over
        ``model``, whichever of the two the mesh carries (the index is a
        host int). Keyed on the name: an unknown one raises."""
        seq, model = self.seq_axis, self.model_axis
        if name in ("k", "v"):
            return (None, seq, model, None)
        if name in ("k_scale", "v_scale"):
            return (None, seq, model)
        raise ValueError(f"unknown cache variable {name!r}: add its decode-mesh spec to "
                         "LMGenerator._cache_spec before sharding it")

    def init_cache(self, batch: int) -> KVCache:
        """Fresh zero cache for ``batch`` rows: (B, max_len, H_kv, D) per
        layer on the model's device, in its compute dtype or, quantized,
        int8 with (B, max_len, H_kv) f32 scales; index 0. With a mesh, a
        :class:`RankKVCache` of rank stacks, each rank's shape its share of
        those under :meth:`_cache_spec`."""
        if self.cache_quant not in CACHE_QUANTS:
            raise ValueError(f"cache_quant must be None or 'int8', got {self.cache_quant!r}")
        m = self.model
        dev = m.embedding.device
        quant = self.cache_quant == "int8"
        full = {"k": (batch, self.max_len, m.n_kv_heads, m.head_dim)}
        full["k_scale"] = full["k"][:3]
        full["v"], full["v_scale"] = full["k"], full["k_scale"]
        dtypes = {"k": torch.int8 if quant else m.compute_dtype, "k_scale": torch.float32}
        dtypes["v"], dtypes["v_scale"] = dtypes["k"], dtypes["k_scale"]

        def zeros(name):
            shape = full[name]
            if self.sharded:
                shape = (self.mesh.size, *local_shape(shape, self._cache_spec(name), self.mesh))
            return [torch.zeros(shape, dtype=dtypes[name], device=dev)
                    for _ in range(m.n_layers)]

        names = ("k", "v", "k_scale", "v_scale") if quant else ("k", "v")
        parts = {name: zeros(name) for name in names}
        if self.sharded:
            return RankKVCache(**parts, index=0, seq_shards=self.sp)
        return KVCache(**parts, index=0)

    def global_cache(self, cache: KVCache) -> KVCache:
        """A mesh cache's global form: each layer's (B, max_len, H_kv, D)
        payloads (and scales) put together from the ranks' shares, from the
        first rank of the replicated ``data`` axis. An unsharded cache as it
        is."""
        if not self.sharded:
            return cache

        def whole(name):
            parts = getattr(cache, name)
            if parts is None:
                return None
            spec = self._cache_spec(name)
            return [rank_unview(self.mesh.grid(t), spec, self.mesh) for t in parts]

        return KVCache(whole("k"), whole("v"), cache.index, whole("k_scale"),
                       whole("v_scale"))

    def place_params(self) -> dict[str, torch.Tensor]:
        """Every parameter as its grid-form rank view over the mesh: its
        ``tp_param_specs`` shard under TP, else the whole leaf (views, no
        copy); the model's own parameters without a mesh."""
        m = self.model
        if not self.sharded:
            return dict(m.named_parameters())
        specs = (tp_param_specs(m, "model") if self.tp > 1
                 else {name: () for name, _ in m.named_parameters()})
        return {name: rank_view(p, specs[name], self.mesh) for name, p in m.named_parameters()}

    @torch.no_grad()
    def step(self, cache: KVCache, tokens: torch.Tensor, *,
             params: dict[str, torch.Tensor] | None = None,
             every_rank: bool = False) -> torch.Tensor:
        """One decode step: ``tokens`` (B, t) at the cache's index, which
        then moves by t; returns the logits (B, t, vocab), or with a mesh and
        ``every_rank`` every rank's (R, B, t, vocab). ``params``: the
        parameters as :meth:`place_params` gives them (computed when not
        given)."""
        if not self.sharded:
            return self.model.forward_one(tokens, cache)
        if params is None:
            params = self.place_params()
        stack = tokens[None].expand(self.mesh.size, *tokens.shape)
        logits = self.model.decode_ranks(stack, cache, self.mesh, params,
                                         seq_axis=self.seq_axis, model_axis=self.model_axis)
        return logits if every_rank else logits[0]

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
        params = self.place_params()
        # prefill: the whole prompt in one forward fills the cache
        logits = self.step(cache, prompt.to(dev), params=params)
        tok = sample(logits[:, -1])
        out = [tok]
        for _ in range(steps - 1):
            logits = self.step(cache, tok[:, None], params=params)
            tok = sample(logits[:, -1])
            out.append(tok)
        return torch.stack(out, dim=1).to(torch.int32)

    @torch.no_grad()
    def decode_logits(self, tokens: torch.Tensor, *, chunk: int = 1,
                      every_rank: bool = False) -> torch.Tensor:
        """Teacher-forced logits via the cache path: feed ``tokens`` (B, T)
        in ``chunk``-sized pieces and return (B, T, vocab), the oracle hook
        that must equal the training forward's logits. ``every_rank``: with
        a mesh, every rank's logits, (R, B, T, vocab)."""
        b, t = tokens.shape
        if t % chunk:
            raise ValueError(f"t={t} not divisible by chunk={chunk}")
        cache = self.init_cache(b)
        params = self.place_params()
        tokens = tokens.to(self.model.embedding.device)
        outs = [self.step(cache, tokens[:, i:i + chunk], params=params, every_rank=every_rank)
                for i in range(0, t, chunk)]
        return torch.cat(outs, dim=-2)
