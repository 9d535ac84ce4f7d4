"""The plain reference against the port's CPU path at a tiny size (this
test imports both; the reference itself imports nothing of the port)."""
from __future__ import annotations

import json

import pytest
import torch

from perfbench import weights
from perfbench.reference import llama as ref
from perfbench.weights import Dims


@pytest.fixture
def tiny(tiny_config):
    with open(tiny_config) as f:
        cfg = json.load(f)
    cfg['torch_dtype'] = 'float32'
    from perfbench import model
    return Dims.of(cfg), model.llama_config(cfg)


def test_blocked_attention_and_its_backward_match_autograd():
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 4, 37, 8, generator=g, dtype=torch.float64)
    k = torch.randn(2, 2, 37, 8, generator=g, dtype=torch.float64)
    v = torch.randn(2, 2, 37, 8, generator=g, dtype=torch.float64)
    dout = torch.randn(2, 4, 37, 8, generator=g, dtype=torch.float64)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = ref.attention(*leaves, block=16)
    got = torch.autograd.grad(out, leaves, dout)
    plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ke = plain[1].repeat_interleave(2, 1)
    ve = plain[2].repeat_interleave(2, 1)
    s = plain[0] @ ke.transpose(-1, -2) * 8 ** -0.5
    s = s.masked_fill(~torch.ones(37, 37, dtype=torch.bool).tril(),
                      float('-inf'))
    want_out = torch.softmax(s, -1) @ ve
    want = torch.autograd.grad(want_out, plain, dout)
    assert torch.allclose(out, want_out, atol=1e-10)
    for a, b in zip(got, want):
        assert torch.allclose(a, b, atol=1e-10)


def test_logits_match_the_port(tiny):
    from skypilot_tpu_torch.models import llama
    dims, config = tiny
    tree = weights.make(dims, 5, 'cpu', torch.float32)
    tokens = torch.randint(0, dims.vocab, (40,),
                           generator=torch.Generator().manual_seed(1))
    ours = ref.logits(dims, tree, tokens)
    theirs = llama.forward(config, tree, tokens[None])[0]
    assert torch.allclose(ours, theirs, atol=2e-4, rtol=1e-4)


def test_loss_and_gradients_match_the_port(tiny):
    from skypilot_tpu_torch.models import llama
    dims, config = tiny
    tree = weights.make(dims, 6, 'cpu', torch.float32)
    ids = torch.randint(0, dims.vocab, (2, 33),
                        generator=torch.Generator().manual_seed(2))
    tokens, targets = ids[:, :-1], ids[:, 1:]
    loss, grads = ref.loss_and_grads(dims, tree, tokens, targets)
    leaves = [leaf.clone().requires_grad_(True)
              for _, leaf in weights.leaves(tree)]
    it = iter(leaves)
    port_tree = {'embed': next(it),
                 'layers': {k: next(it) for k in weights.LAYER_LEAVES},
                 'final_norm': next(it), 'lm_head': next(it)}
    port_loss = llama.loss_fn(config, port_tree, tokens, targets)
    port_grads = torch.autograd.grad(port_loss, leaves)
    assert loss == pytest.approx(float(port_loss.detach()), rel=1e-5)
    for (path, g), pg in zip(weights.leaves(grads), port_grads):
        err = float((g - pg).norm() / pg.norm().clamp(min=1e-12))
        assert err < 1e-4, path


def test_adamw_matches_the_port():
    from skypilot_tpu_torch.train import trainer
    dims = Dims(vocab=16, d=8, ffn=16, layers=2, hq=2, hkv=1, hd=4,
                eps=1e-5, theta=1e4)
    opt = trainer.make_optimizer(learning_rate=1e-2, warmup_steps=2,
                                 total_steps=10)
    ours = weights.make(dims, 3, 'cpu', torch.float32)
    theirs = weights.make(dims, 3, 'cpu', torch.float32)
    state = opt.init(theirs)
    mine = {'mu': opt.init(ours)['mu'], 'nu': opt.init(ours)['nu']}
    for count in range(3):
        grads = weights.make(dims, 100 + count, 'cpu', torch.float32)
        lr = ref.warmup_cosine(count, 1e-2, 2, 10)
        assert lr == pytest.approx(opt.schedule(count))
        n1 = ref.adamw_step(ours, grads, mine, count, lr)
        n2 = opt.update(grads, state, theirs)
        assert n1 == pytest.approx(float(n2), rel=1e-6)
    for (_, a), (_, b) in zip(weights.leaves(ours), weights.leaves(theirs)):
        assert torch.allclose(a, b, atol=1e-6)
