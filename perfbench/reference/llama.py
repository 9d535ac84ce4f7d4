"""The decoder as its model card describes it, in plain float32 PyTorch.

Mistral-7B-v0.3 (and the Llama family it shares its layer with): token
embedding; per layer x += Wo · attn(RoPE(Wq · n1(x)), RoPE(Wk · n1(x)),
Wv · n1(x)) and x += Wdown · (silu(Wgate · n2(x)) * Wup · n2(x)), with
RMSNorm n(x) = x / sqrt(mean(x^2) + eps) * gain, rotary embeddings
rotating the two halves of each head (``rotate_half``), grouped-query
attention (query head h reads KV head h // (hq / hkv)), causal softmax
scaled by hd^-0.5; a final RMSNorm and an untied head.

Every product is float32 with TF32 off; the weights arrive as the
benchmark made them (bf16) and are widened exactly, a layer at a time.
Attention runs in blocks of queries so that the score matrix of a long
sequence never exists whole; its backward is written out (softmax's
Jacobian over each block), so a training step never keeps a layer's
scores either.

``Lin`` is the one place products happen: the control computes the same
model with each product's operands rounded to float8 (e4m3, one scale a
tensor), the precision below the bf16 the configuration states.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from perfbench.weights import LAYER_LEAVES, Dims


def exact() -> None:
    """Float32 products in float32: no TF32 anywhere."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision('highest')


class Lin:
    """Products and weight widening: float32 (``fp8=False``) or with
    both operands rounded through float8 e4m3 at one scale a tensor."""

    def __init__(self, fp8: bool = False) -> None:
        self.fp8 = fp8

    def _round(self, t: torch.Tensor) -> torch.Tensor:
        scale = t.detach().abs().amax().clamp(min=1e-30) / 448.0
        q = (t / scale).to(torch.float8_e4m3fn).to(torch.float32)
        # Straight-through: the rounding's gradient is the identity.
        return t + (q * scale - t).detach()

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.fp8:
            x, w = self._round(x), self._round(w)
        return x @ w


def rope_tables(hd: int, n: int, theta: float, device
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float64,
                                        device=device) / hd))
    f = torch.outer(torch.arange(n, dtype=torch.float64, device=device), inv)
    return torch.cos(f).float(), torch.sin(f).float()


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
         ) -> torch.Tensor:
    """x [b, s, h, hd] at positions 0..s-1."""
    s = x.shape[1]
    c, sn = cos[:s][None, :, None, :], sin[:s][None, :, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * c - x2 * sn, x2 * c + x1 * sn], dim=-1)


def rms(x: torch.Tensor, gain: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * gain


class _Attention(torch.autograd.Function):
    """Causal grouped-query attention in blocks of ``block`` queries.
    q [b, hq, s, hd], k/v [b, hkv, s, hd]; float32."""

    @staticmethod
    def forward(ctx, q, k, v, block):
        b, hq, s, hd = q.shape
        group = hq // k.shape[1]
        ke = k.repeat_interleave(group, dim=1)
        ve = v.repeat_interleave(group, dim=1)
        scale = hd ** -0.5
        out = torch.empty_like(q)
        lse = torch.empty(b, hq, s, device=q.device, dtype=q.dtype)
        for a in range(0, s, block):
            e = min(s, a + block)
            sc = (q[:, :, a:e] @ ke[:, :, :e].transpose(-1, -2)) * scale
            mask = (torch.arange(a, e, device=q.device)[:, None]
                    >= torch.arange(e, device=q.device)[None, :])
            sc = sc.masked_fill(~mask, float('-inf'))
            m = sc.logsumexp(-1, keepdim=True)
            out[:, :, a:e] = torch.exp(sc - m) @ ve[:, :, :e]
            lse[:, :, a:e] = m[..., 0]
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.block = block
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        block = ctx.block
        b, hq, s, hd = q.shape
        hkv = k.shape[1]
        group = hq // hkv
        ke = k.repeat_interleave(group, dim=1)
        ve = v.repeat_interleave(group, dim=1)
        scale = hd ** -0.5
        dq = torch.zeros_like(q)
        dke = torch.zeros_like(ke)
        dve = torch.zeros_like(ve)
        delta = (dout * out).sum(-1)
        for a in range(0, s, block):
            e = min(s, a + block)
            sc = (q[:, :, a:e] @ ke[:, :, :e].transpose(-1, -2)) * scale
            mask = (torch.arange(a, e, device=q.device)[:, None]
                    >= torch.arange(e, device=q.device)[None, :])
            p = torch.exp(sc - lse[:, :, a:e, None]).masked_fill(~mask, 0.0)
            do = dout[:, :, a:e]
            dve[:, :, :e] += p.transpose(-1, -2) @ do
            dp = do @ ve[:, :, :e].transpose(-1, -2)
            ds = p * (dp - delta[:, :, a:e, None]) * scale
            dq[:, :, a:e] = ds @ ke[:, :, :e]
            dke[:, :, :e] += ds.transpose(-1, -2) @ q[:, :, a:e]
        dk = dke.reshape(b, hkv, group, s, hd).sum(2)
        dv = dve.reshape(b, hkv, group, s, hd).sum(2)
        return dq, dk, dv, None


def attention(q, k, v, block: int = 1024):
    return _Attention.apply(q, k, v, block)


def layer(dims: Dims, x: torch.Tensor, w: Dict[str, torch.Tensor],
          cos: torch.Tensor, sin: torch.Tensor, lin: Lin) -> torch.Tensor:
    """One decoder layer on x [b, s, d] (float32 weights ``w``)."""
    b, s, d = x.shape
    h = rms(x, w['attn_norm'], dims.eps)
    q = rope(lin.mm(h, w['wq']).view(b, s, dims.hq, dims.hd), cos, sin)
    k = rope(lin.mm(h, w['wk']).view(b, s, dims.hkv, dims.hd), cos, sin)
    v = lin.mm(h, w['wv']).view(b, s, dims.hkv, dims.hd)
    att = attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    x = x + lin.mm(att.transpose(1, 2).reshape(b, s, dims.hq * dims.hd),
                   w['wo'])
    h = rms(x, w['mlp_norm'], dims.eps)
    gate = torch.nn.functional.silu(lin.mm(h, w['w_gate']))
    return x + lin.mm(gate * lin.mm(h, w['w_up']), w['w_down'])


def layer_weights(tree: Dict, i: int) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s weights widened to float32."""
    return {k: tree['layers'][k][i].float() for k in LAYER_LEAVES}


@torch.no_grad()
def logits(dims: Dims, tree: Dict, tokens: torch.Tensor) -> torch.Tensor:
    """tokens [s] -> float32 logits [s, V] of a causal forward pass."""
    lin = Lin()
    cos, sin = rope_tables(dims.hd, tokens.shape[0], dims.theta,
                           tokens.device)
    x = tree['embed'][tokens.long()].float()[None]
    for i in range(dims.layers):
        x = layer(dims, x, layer_weights(tree, i), cos, sin, lin)
    x = rms(x, tree['final_norm'].float(), dims.eps)
    return lin.mm(x[0], tree['lm_head'].float())


# ---- training ----------------------------------------------------------
def _head_loss(dims: Dims, x: torch.Tensor, gain: torch.Tensor,
               head: torch.Tensor, targets: torch.Tensor, lin: Lin,
               rows: int = 4096) -> torch.Tensor:
    """Mean next-token cross-entropy of x [T, d] (in blocks of rows, each
    block's logits freed after its backward is set up by autograd)."""
    h = rms(x, gain, dims.eps)
    total = 0.0
    for a in range(0, x.shape[0], rows):
        z = lin.mm(h[a:a + rows], head)
        total = total + torch.nn.functional.cross_entropy(
            z, targets[a:a + rows].long(), reduction='sum')
    return total / x.shape[0]


def loss_and_grads(dims: Dims, tree: Dict, tokens: torch.Tensor,
                   targets: torch.Tensor, lin: Optional[Lin] = None
                   ) -> Tuple[float, Dict]:
    """The mean loss over ``tokens`` [b, s] and float32 gradients of
    every leaf, layer by layer: the forward keeps only each layer's
    input; the backward runs each layer again under autograd."""
    lin = lin or Lin()
    b, s = tokens.shape
    dev = tokens.device
    cos, sin = rope_tables(dims.hd, s, dims.theta, dev)
    inputs: List[torch.Tensor] = []
    with torch.no_grad():
        x = tree['embed'][tokens.long()].float()
        for i in range(dims.layers):
            inputs.append(x)
            x = layer(dims, x, layer_weights(tree, i), cos, sin, lin)
    x = x.detach().requires_grad_(True)
    gain = tree['final_norm'].float().requires_grad_(True)
    head = tree['lm_head'].float().requires_grad_(True)
    loss = _head_loss(dims, x.view(b * s, -1), gain, head,
                      targets.reshape(-1), lin)
    gx, ggain, ghead = torch.autograd.grad(loss, (x, gain, head))
    grads: Dict = {'layers': {k: torch.empty(tree['layers'][k].shape,
                                             dtype=torch.float32, device=dev)
                              for k in LAYER_LEAVES},
                   'final_norm': ggain, 'lm_head': ghead}
    del x, gain, head
    for i in reversed(range(dims.layers)):
        xi = inputs.pop().requires_grad_(True)
        w = {k: t.requires_grad_(True)
             for k, t in layer_weights(tree, i).items()}
        out = layer(dims, xi, w, cos, sin, lin)
        got = torch.autograd.grad(out, [xi] + [w[k] for k in LAYER_LEAVES],
                                  gx)
        gx = got[0]
        for k, g in zip(LAYER_LEAVES, got[1:]):
            grads['layers'][k][i] = g
        del xi, w, out, got
    grads['embed'] = torch.zeros(tree['embed'].shape, dtype=torch.float32,
                                 device=dev).index_add_(
        0, tokens.reshape(-1).long(), gx.reshape(b * s, -1))
    return float(loss.detach()), grads


def adamw_step(tree: Dict, grads: Dict, state: Dict, count: int,
               lr: float, b1: float = 0.9, b2: float = 0.95,
               eps: float = 1e-8, weight_decay: float = 0.1,
               clip: float = 1.0) -> float:
    """optax's clip_by_global_norm then adamw, in float32 from float32
    gradients, the moments and parameters stored back in their own
    (bf16) dtype. ``count`` is the update's index from 0. Returns the
    gradient's global norm before clipping."""
    from perfbench.weights import leaves
    pairs = list(zip(leaves(tree), leaves(grads), leaves(state['mu']),
                     leaves(state['nu'])))
    norm = float(torch.sqrt(sum((g.double() ** 2).sum()
                                for _, (_, g), _, _ in pairs)))
    factor = clip / norm if norm >= clip else 1.0
    bc1 = 1.0 - b1 ** (count + 1)
    bc2 = 1.0 - b2 ** (count + 1)
    with torch.no_grad():
        for (_, p), (_, g), (_, mu), (_, nu) in pairs:
            g = g * factor
            m = (1 - b1) * g + b1 * mu.float()
            n = (1 - b2) * g * g + b2 * nu.float()
            u = (m / bc1) / (torch.sqrt(n / bc2) + eps) \
                + weight_decay * p.float()
            p.copy_(p.float() - lr * u)
            mu.copy_(m)
            nu.copy_(n)
    return norm


def warmup_cosine(count: int, lr: float, warmup: int, total: int) -> float:
    """optax.warmup_cosine_decay_schedule(0, lr, warmup, total) at
    ``count``."""
    import math
    if count < warmup:
        return lr * count / warmup
    decay = max(total, warmup + 1) - warmup
    c = min(count - warmup, decay)
    return lr * 0.5 * (1 + math.cos(math.pi * c / decay))
