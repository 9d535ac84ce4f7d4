"""ResNet v1.5 with GroupNorm (counterpart of
``skypilot_tpu/models/resnet.py``), the vision workload of the DDP
recipe (``train/run_vision.py``).

The config with its presets, ``init_params``, ``forward`` and
``loss_fn`` compute the reference's function:

- images arrive NHWC, as in the reference, and run NCHW through
  ``F.conv2d`` (a channels-last view: the permute copies nothing); conv
  weights are ``[out, in, kh, kw]`` (the reference's are HWIO:
  :func:`params_from_jax` transposes them);
- ``'SAME'`` padding is XLA's: for a stride of 2 the extra row and column
  go at the end (``F.conv2d``'s symmetric padding would shift the window
  by one), so uneven pads are applied with ``F.pad`` first; the stem's
  max pool pads with ``-inf`` the same way;
- GroupNorm groups consecutive channels, in fp32, as the reference's
  ``_group_norm`` does on its minor channel axis and ``F.group_norm``
  does on NCHW; the affine is in fp32, the result cast back.

The JAX package has no Pallas kernel in this model: convolutions are
cuDNN's through ``F.conv2d``, as XLA's are the reference's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from skypilot_tpu_torch.models.llama import torch_dtype

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: Tuple[int, ...] = (2, 2, 2, 2)     # resnet18
    num_classes: int = 1000
    width: int = 64
    groups: int = 32                                # groupnorm groups
    dtype: str = 'bfloat16'

    @staticmethod
    def resnet18(**kw) -> 'ResNetConfig':
        return ResNetConfig(**kw)

    @staticmethod
    def resnet50(**kw) -> 'ResNetConfig':
        base = dict(stage_sizes=(3, 4, 6, 3))
        base.update(kw)
        return ResNetConfig(**base)

    @staticmethod
    def tiny(**kw) -> 'ResNetConfig':
        base = dict(stage_sizes=(1, 1), num_classes=10, width=8,
                    groups=4, dtype='float32')
        base.update(kw)
        return ResNetConfig(**base)


def _stride(stage: int, block: int) -> int:
    return 2 if (block == 0 and stage > 0) else 1


def init_params(config: ResNetConfig, generator: torch.Generator,
                device='cpu') -> Params:
    """He-normal convs and a scaled-normal head with the reference's
    shapes and scales (drawn from ``generator``, so not its
    ``jax.random`` bits; tests use :func:`params_from_jax`)."""
    dtype = torch_dtype(config.dtype)

    def conv(kh, kw, cin, cout):
        w = torch.randn((cout, cin, kh, kw), generator=generator,
                        device=device)
        return (w * (2.0 / (kh * kw * cin)) ** 0.5).to(dtype)

    def gn(c):
        return {'scale': torch.ones((c,), dtype=dtype, device=device),
                'bias': torch.zeros((c,), dtype=dtype, device=device)}

    w = config.width
    params: Params = {'stem': conv(7, 7, 3, w), 'stem_gn': gn(w),
                      'stages': []}
    cin = w
    for i, blocks in enumerate(config.stage_sizes):
        cout = w * (2 ** i)
        stage: List[Dict[str, Any]] = []
        for b in range(blocks):
            block = {'conv1': conv(3, 3, cin, cout), 'gn1': gn(cout),
                     'conv2': conv(3, 3, cout, cout), 'gn2': gn(cout)}
            if _stride(i, b) != 1 or cin != cout:
                block['proj'] = conv(1, 1, cin, cout)
            stage.append(block)
            cin = cout
        params['stages'].append(stage)
    head = torch.randn((cin, config.num_classes), generator=generator,
                       device=device)
    params['head'] = (head * cin ** -0.5).to(dtype)
    return params


def params_from_jax(tree: Params, device='cpu') -> Params:
    """Carry a reference parameter tree across (numpy arrays, as
    ``jax.tree.map(np.asarray, params)`` gives them): HWIO convs become
    ``[out, in, kh, kw]``, everything else is copied as it is."""
    def convert(a, conv):
        a = np.asarray(a)
        if a.dtype.name == 'bfloat16':
            t = torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a))
        if conv:
            t = t.permute(3, 2, 0, 1).contiguous()
        return t.to(device)

    def walk(node, key=''):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, key) for v in node]
        return convert(node, key in ('stem', 'conv1', 'conv2', 'proj'))
    return walk(tree)


def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's 'SAME' padding of one spatial axis: (before, after)."""
    out = math.ceil(size / stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, k: int, stride: int,
              value: float = 0.0) -> Tuple[torch.Tensor, int]:
    """``x`` (NCHW) padded for a ``k`` x ``k`` window at ``stride`` as
    XLA's 'SAME' pads it; returns (x, the symmetric padding left for the
    op)."""
    (top, bottom), (left, right) = (_same_pads(x.shape[2], k, stride),
                                    _same_pads(x.shape[3], k, stride))
    if top == bottom == left == right:
        return x, top
    return F.pad(x, (left, right, top, bottom), value=value), 0


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    x, pad = _pad_same(x, w.shape[-1], stride)
    return F.conv2d(x, w, stride=stride, padding=pad)


def _group_norm(x: torch.Tensor, gn: Params, groups: int,
                eps: float = 1e-5) -> torch.Tensor:
    g = min(groups, x.shape[1])
    y = F.group_norm(x.float(), g, gn['scale'].float(), gn['bias'].float(),
                     eps)
    return y.to(x.dtype)


def forward(config: ResNetConfig, params: Params,
            images: torch.Tensor) -> torch.Tensor:
    """images [n, h, w, 3] -> logits [n, classes] (fp32)."""
    x = images.to(torch_dtype(config.dtype)).permute(0, 3, 1, 2)
    x = _conv(x, params['stem'], stride=2)
    x = F.relu(_group_norm(x, params['stem_gn'], config.groups))
    x, pad = _pad_same(x, 3, 2, value=float('-inf'))
    x = F.max_pool2d(x, 3, 2, padding=pad)
    for i, stage in enumerate(params['stages']):
        for b, block in enumerate(stage):
            stride = _stride(i, b)
            h = F.relu(_group_norm(_conv(x, block['conv1'], stride),
                                   block['gn1'], config.groups))
            h = _group_norm(_conv(h, block['conv2']), block['gn2'],
                            config.groups)
            shortcut = (_conv(x, block['proj'], stride)
                        if 'proj' in block else x)
            x = F.relu(shortcut + h)
    x = x.mean(dim=(2, 3))                        # global avg pool
    return (x @ params['head']).float()


def loss_fn(config: ResNetConfig, params: Params, images: torch.Tensor,
            labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy of the logits at ``labels``."""
    logp = torch.log_softmax(forward(config, params, images), dim=-1)
    return -logp.gather(-1, labels.long()[:, None]).mean()
