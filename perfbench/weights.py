"""Seeded weights and their shapes, made by the benchmark itself.

The tree is the port's stacked layout (``models/llama.py``): ``embed``
``[V, d]``; ``layers`` with ``attn_norm``, ``mlp_norm`` ``[L, d]``,
``wq`` ``[L, d, hq*hd]``, ``wk``/``wv`` ``[L, d, hkv*hd]``, ``wo``
``[L, hq*hd, d]``, ``w_gate``/``w_up`` ``[L, d, f]``, ``w_down``
``[L, f, d]``; ``final_norm`` ``[d]``; ``lm_head`` ``[d, V]``. The
program and the plain reference get the same tensors' values: each leaf
comes from its own generator, seeded from (seed, leaf), in one call on
the device, so any leaf can be made again alone and bit for bit.

Scales: products into the residual stream draw N(0, 1/d), those out of
it N(0, 1/(2 L d)) (GPT-2's residual scaling), the embedding N(0, 1),
the norms' gains 1 + N(0, 0.1^2) so that a program that ignores a gain
parts from the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Tuple

import torch

LAYER_LEAVES = ('attn_norm', 'wq', 'wk', 'wv', 'wo', 'mlp_norm', 'w_gate',
                'w_up', 'w_down')


@dataclasses.dataclass(frozen=True)
class Dims:
    """The widths of a configuration file (Hugging Face key names)."""
    vocab: int
    d: int
    ffn: int
    layers: int
    hq: int
    hkv: int
    hd: int
    eps: float
    theta: float

    @staticmethod
    def of(config: Dict) -> 'Dims':
        return Dims(vocab=config['vocab_size'], d=config['hidden_size'],
                    ffn=config['intermediate_size'],
                    layers=config['num_hidden_layers'],
                    hq=config['num_attention_heads'],
                    hkv=config['num_key_value_heads'],
                    hd=config['head_dim'], eps=config['rms_norm_eps'],
                    theta=config['rope_theta'])


def leaf_specs(dims: Dims) -> Iterator[Tuple[Tuple[str, ...], tuple, str,
                                             float]]:
    """(path, shape, kind, scale) of every leaf, in a fixed order."""
    d, L, hd = dims.d, dims.layers, dims.hd
    out_scale = (d ** -0.5) / (2 * L) ** 0.5
    yield ('embed',), (dims.vocab, d), 'normal', 1.0
    shapes = {
        'attn_norm': ((L, d), 'gain', 0.1),
        'wq': ((L, d, dims.hq * hd), 'normal', d ** -0.5),
        'wk': ((L, d, dims.hkv * hd), 'normal', d ** -0.5),
        'wv': ((L, d, dims.hkv * hd), 'normal', d ** -0.5),
        'wo': ((L, dims.hq * hd, d), 'normal', out_scale),
        'mlp_norm': ((L, d), 'gain', 0.1),
        'w_gate': ((L, d, dims.ffn), 'normal', d ** -0.5),
        'w_up': ((L, d, dims.ffn), 'normal', d ** -0.5),
        'w_down': ((L, dims.ffn, d), 'normal', out_scale),
    }
    for name in LAYER_LEAVES:
        shape, kind, scale = shapes[name]
        yield ('layers', name), shape, kind, scale
    yield ('final_norm',), (d,), 'gain', 0.1
    yield ('lm_head',), (d, dims.vocab), 'normal', d ** -0.5


def _leaf_seed(seed: int, index: int) -> int:
    return (int(seed) * 1_000_003 + 7919 * (index + 1)) % (2 ** 63 - 1)


def make_leaf(dims: Dims, path: Tuple[str, ...], seed: int, device,
              dtype=torch.bfloat16) -> torch.Tensor:
    """The one leaf at ``path``, as :func:`make` makes it."""
    for i, (p, shape, kind, scale) in enumerate(leaf_specs(dims)):
        if p == path:
            gen = torch.Generator(device=device)
            gen.manual_seed(_leaf_seed(seed, i))
            t = torch.randn(shape, generator=gen, device=device,
                            dtype=dtype)
            t.mul_(scale)
            if kind == 'gain':
                t.add_(1.0)
            return t
    raise KeyError(path)


def make(dims: Dims, seed: int, device, dtype=torch.bfloat16) -> Dict:
    """The whole tree on ``device`` in ``dtype``."""
    tree: Dict = {'layers': {}}
    for path, *_ in leaf_specs(dims):
        leaf = make_leaf(dims, path, seed, device, dtype)
        if path[0] == 'layers':
            tree['layers'][path[1]] = leaf
        else:
            tree[path[0]] = leaf
    return tree


def leaves(tree: Dict) -> Iterator[Tuple[Tuple[str, ...], torch.Tensor]]:
    """(path, leaf) in :func:`leaf_specs`' order."""
    yield ('embed',), tree['embed']
    for name in LAYER_LEAVES:
        yield ('layers', name), tree['layers'][name]
    yield ('final_norm',), tree['final_norm']
    yield ('lm_head',), tree['lm_head']


def sample_index(numel: int, seed: int, leaf: int, k: int, device):
    """``k`` element indices (or all of them, where a leaf has fewer) of
    a flattened leaf, drawn from (seed, leaf) on ``device``: the same
    elements for the program's gradient and the reference's."""
    if numel <= k:
        return torch.arange(numel, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(_leaf_seed(seed, 1000 + leaf))
    return torch.randint(0, numel, (k,), generator=gen, device=device)


def matmul_params(dims: Dims) -> int:
    """Parameters that enter a product for every token: the layers'
    projections and the head (the embedding is a lookup)."""
    per_layer = dims.d * dims.hd * (2 * dims.hq + 2 * dims.hkv) \
        + 3 * dims.d * dims.ffn
    return dims.layers * per_layer + dims.d * dims.vocab
