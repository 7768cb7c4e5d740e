"""Weights carried across from the JAX package's flax parameter trees.

:func:`transformer_state_dict_from_flax`, :func:`moe_state_dict_from_flax`,
:func:`mlp_state_dict_from_flax` and :func:`resnet_state_dict_from_flax`
map a ``TransformerLM``, ``MoETransformerLM``, ``MLP`` or ``ResNet`` flax
tree, given as nested dicts of numpy arrays (``{"params": {...}}`` or the
inner dict), to the ``state_dict`` of :class:`.transformer.TransformerLM`,
:class:`.transformer.MoETransformerLM`, :class:`.mlp.MLP` or
:class:`.resnet.ResNet`. The port keeps the flax shapes (a conv kernel
stays HWIO), so each leaf is renamed, never transposed. An unknown or a
missing leaf raises ``ValueError``. :func:`flax_path` maps the other way,
one port parameter name of the dense models to its flax path, and
:func:`moe_flax_path` one of the MoE LM's (the binder orders a flat
parameter vector by them).
"""

from __future__ import annotations

import re
from collections.abc import Mapping

import numpy as np
import torch

_BLOCK_LEAVES = {
    "Attention_0/q/kernel": "attn.q_kernel",
    "Attention_0/q/bias": "attn.q_bias",
    "Attention_0/k/kernel": "attn.k_kernel",
    "Attention_0/k/bias": "attn.k_bias",
    "Attention_0/v/kernel": "attn.v_kernel",
    "Attention_0/v/bias": "attn.v_bias",
    "Attention_0/out/kernel": "attn.out_kernel",
    "Attention_0/out_bias": "attn.out_bias",
    "LayerNorm_0/scale": "ln1.scale",
    "LayerNorm_0/bias": "ln1.bias",
    "LayerNorm_1/scale": "ln2.scale",
    "LayerNorm_1/bias": "ln2.bias",
    "mlp_up/kernel": "mlp_up_kernel",
    "mlp_up/bias": "mlp_up_bias",
    "mlp_down/kernel": "mlp_down_kernel",
    "mlp_bias": "mlp_bias",
}
# MoEBlock_i: the attention and norms of Block_i, the router and the experts
_MOE_BLOCK_LEAVES = {
    **{path: name for path, name in _BLOCK_LEAVES.items()
       if path.startswith(("Attention_0/", "LayerNorm_"))},
    "router": "router",
    "moe_w1": "moe_w1",
    "moe_b1": "moe_b1",
    "moe_w2": "moe_w2",
}
_TOP_LEAVES = {
    "Embed_0/embedding": "embedding",
    "LayerNorm_0/scale": "ln_f.scale",
    "LayerNorm_0/bias": "ln_f.bias",
    "Dense_0/kernel": "head_kernel",
    "Dense_0/bias": "head_bias",
}
_BLOCK = re.compile(r"Block_(\d+)/(.+)")
_MOE_BLOCK = re.compile(r"MoEBlock_(\d+)/(.+)")


def _flatten(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    flat = {}
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, Mapping):
            flat.update(_flatten(val, path + "/"))
        else:
            flat[path] = np.asarray(val)
    return flat


_TOP_PATHS = {name: tuple(path.split("/")) for path, name in _TOP_LEAVES.items()}
_BLOCK_PATHS = {name: tuple(path.split("/")) for path, name in _BLOCK_LEAVES.items()}
_MOE_BLOCK_PATHS = {name: tuple(path.split("/")) for path, name in _MOE_BLOCK_LEAVES.items()}
_PORT_BLOCK = re.compile(r"blocks\.(\d+)\.(.+)")
_DENSE = re.compile(r"Dense_(\d+)/(kernel|bias)")
_PORT_DENSE = re.compile(r"dense\.(\d+)\.(kernel|bias)")
# ResNet: the stem, the head, and Bottleneck_i's Conv_j / GroupNorm_j
_RESNET_TOP = {
    "Conv_0/kernel": "conv.kernel",
    "GroupNorm_0/scale": "norm.scale",
    "GroupNorm_0/bias": "norm.bias",
    "Dense_0/kernel": "head.kernel",
    "Dense_0/bias": "head.bias",
}
_RESNET_TOP_PATHS = {name: tuple(path.split("/")) for path, name in _RESNET_TOP.items()}
_BOTTLENECK = re.compile(r"Bottleneck_(\d+)/(Conv|GroupNorm)_(\d+)/(kernel|scale|bias)")
_PORT_BOTTLENECK = re.compile(r"blocks\.(\d+)\.(conv|norm)\.(\d+)\.(kernel|scale|bias)")
_LAYER = {"Conv": "conv", "GroupNorm": "norm", "conv": "Conv", "norm": "GroupNorm"}


def flax_path(name: str) -> tuple[str, ...]:
    """The flax path (inside ``params``) of the port's ``TransformerLM``,
    ``MLP`` or ``ResNet`` parameter ``name``, e.g. ``blocks.1.attn.q_kernel``
    -> ``("Block_1", "Attention_0", "q", "kernel")``, ``dense.2.bias`` ->
    ``("Dense_2", "bias")`` or ``blocks.10.norm.3.scale`` ->
    ``("Bottleneck_10", "GroupNorm_3", "scale")``; ``ValueError`` for a name
    with no flax counterpart."""
    if name in _TOP_PATHS:
        return _TOP_PATHS[name]
    if name in _RESNET_TOP_PATHS:
        return _RESNET_TOP_PATHS[name]
    m = _PORT_BOTTLENECK.fullmatch(name)
    if m is not None:
        block, layer, j, leaf = m.groups()
        return (f"Bottleneck_{block}", f"{_LAYER[layer]}_{j}", leaf)
    m = _PORT_DENSE.fullmatch(name)
    if m is not None:
        return (f"Dense_{m.group(1)}", m.group(2))
    m = _PORT_BLOCK.fullmatch(name)
    if m is None or m.group(2) not in _BLOCK_PATHS:
        raise ValueError(f"parameter {name!r} has no flax counterpart")
    return (f"Block_{m.group(1)}", *_BLOCK_PATHS[m.group(2)])


def moe_flax_path(name: str) -> tuple[str, ...]:
    """The flax path of the port's ``MoETransformerLM`` parameter ``name``,
    e.g. ``blocks.1.moe_w1`` -> ``("MoEBlock_1", "moe_w1")`` or
    ``head_kernel`` -> ``("Dense_0", "kernel")``; ``ValueError`` for a name
    with no flax counterpart."""
    if name in _TOP_PATHS:
        return _TOP_PATHS[name]
    m = _PORT_BLOCK.fullmatch(name)
    if m is None or m.group(2) not in _MOE_BLOCK_PATHS:
        raise ValueError(f"parameter {name!r} has no flax counterpart")
    return (f"MoEBlock_{m.group(1)}", *_MOE_BLOCK_PATHS[m.group(2)])


def _lm_state_dict(tree: Mapping, block: re.Pattern, leaves: dict[str, str],
                   prefix: str) -> dict[str, torch.Tensor]:
    """The LM ``state_dict`` of a flax tree whose blocks (``<prefix>_i``)
    match ``block``, each with ``leaves``."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    out: dict[str, torch.Tensor] = {}
    blocks: dict[int, set[str]] = {}
    unknown = []
    for path, arr in _flatten(tree).items():
        name = _TOP_LEAVES.get(path)
        m = block.fullmatch(path)
        if name is None and m is not None and m.group(2) in leaves:
            i = int(m.group(1))
            blocks.setdefault(i, set()).add(m.group(2))
            name = f"blocks.{i}.{leaves[m.group(2)]}"
        if name is None:
            unknown.append(path)
            continue
        out[name] = torch.from_numpy(np.array(arr, dtype=np.float32))
    if unknown:
        raise ValueError(f"flax leaves with no counterpart in the port: {sorted(unknown)}")
    missing = [p for p, n in _TOP_LEAVES.items() if n not in out]
    if blocks and sorted(blocks) != list(range(len(blocks))):
        missing.append(f"{prefix}_i for i in "
                       f"{sorted(set(range(max(blocks) + 1)) - set(blocks))}")
    for i, have in sorted(blocks.items()):
        missing += [f"{prefix}_{i}/{p}" for p in leaves if p not in have]
    if missing:
        raise ValueError(f"flax tree lacks leaves: {missing}")
    return out


def transformer_state_dict_from_flax(tree: Mapping) -> dict[str, torch.Tensor]:
    """The port's ``TransformerLM`` ``state_dict`` from a flax tree.

    Raises ``ValueError`` on a leaf with no counterpart in the port and on
    a leaf the port needs that the tree lacks (blocks numbered from 0 with
    no gap, each with all its leaves).
    """
    return _lm_state_dict(tree, _BLOCK, _BLOCK_LEAVES, "Block")


def moe_state_dict_from_flax(tree: Mapping) -> dict[str, torch.Tensor]:
    """The port's ``MoETransformerLM`` ``state_dict`` from a flax tree:
    ``MoEBlock_i/{Attention_0, LayerNorm_0, LayerNorm_1}`` onto
    ``blocks.i.{attn, ln1, ln2}``, ``MoEBlock_i/{router, moe_w1, moe_b1,
    moe_w2}`` onto the same names in ``blocks.i``, and ``Embed_0``, the
    final ``LayerNorm_0`` and ``Dense_0`` as for ``TransformerLM``. Raises
    ``ValueError`` as :func:`transformer_state_dict_from_flax` does."""
    return _lm_state_dict(tree, _MOE_BLOCK, _MOE_BLOCK_LEAVES, "MoEBlock")


def mlp_state_dict_from_flax(tree: Mapping) -> dict[str, torch.Tensor]:
    """The port's ``MLP`` ``state_dict`` from a flax tree: ``Dense_i/kernel``
    and ``Dense_i/bias`` -> ``dense.i.kernel`` and ``dense.i.bias``.

    Raises ``ValueError`` on a leaf with no counterpart in the port and on
    a leaf the port needs that the tree lacks (layers numbered from 0 with
    no gap, each with its kernel and bias).
    """
    if set(tree) == {"params"}:
        tree = tree["params"]
    out: dict[str, torch.Tensor] = {}
    unknown = []
    for path, arr in _flatten(tree).items():
        m = _DENSE.fullmatch(path)
        if m is None:
            unknown.append(path)
            continue
        out[f"dense.{m.group(1)}.{m.group(2)}"] = torch.from_numpy(
            np.array(arr, dtype=np.float32))
    if unknown:
        raise ValueError(f"flax leaves with no counterpart in the port: {sorted(unknown)}")
    layers = {int(name.split(".")[1]) for name in out}
    missing = [f"Dense_{i}/{leaf}" for i in range(max(layers, default=-1) + 1)
               for leaf in ("kernel", "bias") if f"dense.{i}.{leaf}" not in out]
    if not out:
        missing.append("Dense_0/kernel, Dense_0/bias")
    if missing:
        raise ValueError(f"flax tree lacks leaves: {missing}")
    return out


def resnet_state_dict_from_flax(tree: Mapping) -> dict[str, torch.Tensor]:
    """The port's ``ResNet`` ``state_dict`` from a flax tree:
    ``Bottleneck_i/Conv_j/kernel`` -> ``blocks.i.conv.j.kernel`` (HWIO, as
    flax stores it), ``Bottleneck_i/GroupNorm_j/{scale,bias}`` ->
    ``blocks.i.norm.j.*``, and the stem's ``Conv_0``/``GroupNorm_0`` and the
    head's ``Dense_0`` -> ``conv``, ``norm`` and ``head``.

    Raises ``ValueError`` on a leaf with no counterpart in the port and on
    a leaf the port needs that the tree lacks (the stem and the head whole;
    blocks numbered from 0 with no gap, each with convs and norms 0-2 and
    the projection's 3 either whole or absent).
    """
    if set(tree) == {"params"}:
        tree = tree["params"]
    out: dict[str, torch.Tensor] = {}
    blocks: dict[int, set[str]] = {}
    unknown = []
    for path, arr in _flatten(tree).items():
        name = _RESNET_TOP.get(path)
        m = _BOTTLENECK.fullmatch(path)
        if name is None and m is not None:
            block, layer, j, leaf = m.groups()
            if (layer == "Conv") == (leaf == "kernel") and int(j) <= 3:
                blocks.setdefault(int(block), set()).add(f"{layer}_{j}/{leaf}")
                name = f"blocks.{block}.{_LAYER[layer]}.{j}.{leaf}"
        if name is None:
            unknown.append(path)
            continue
        out[name] = torch.from_numpy(np.array(arr, dtype=np.float32))
    if unknown:
        raise ValueError(f"flax leaves with no counterpart in the port: {sorted(unknown)}")
    missing = [p for p, n in _RESNET_TOP.items() if n not in out]
    if blocks and sorted(blocks) != list(range(len(blocks))):
        missing.append(
            f"Bottleneck_i for i in {sorted(set(range(max(blocks) + 1)) - set(blocks))}")
    for i, leaves in sorted(blocks.items()):
        need = [f"Conv_{j}/kernel" for j in range(3)] + [
            f"GroupNorm_{j}/{leaf}" for j in range(3) for leaf in ("scale", "bias")]
        projection = ["Conv_3/kernel", "GroupNorm_3/scale", "GroupNorm_3/bias"]
        if leaves & set(projection):
            need += projection
        missing += [f"Bottleneck_{i}/{p}" for p in need if p not in leaves]
    if missing:
        raise ValueError(f"flax tree lacks leaves: {missing}")
    return out
