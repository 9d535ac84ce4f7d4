"""The port's sampling vs the JAX reference.

Greedy must be the same token (argmax, first index on ties). Temperature
sampling can never agree bit for bit (``jax.random`` vs
``torch.Generator``), so both are held to the same distribution: over
4000 draws per slot, each side's empirical frequencies lie within 0.03 of
softmax(logits / T) (about 4 standard errors at p = 0.5), and top-k never
draws outside the k largest logits.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from skypilot_tpu.infer import sampling as jsampling
from skypilot_tpu_torch.infer import sampling as tsampling

N_DRAWS = 4000
FREQ_TOL = 0.03


def test_greedy_matches_jax_including_ties():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(6, 50)).astype(np.float32)
    logits[2, [3, 17]] = 9.0        # a tie: the first index wins
    temps = np.zeros((6,), np.float32)
    ref = jsampling.sample(jnp.asarray(logits), jax.random.PRNGKey(0),
                           jnp.asarray(temps))
    out = tsampling.sample(torch.from_numpy(logits), None,
                           torch.from_numpy(temps))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert out[2].item() == 3


def _freqs(draws, vocab):
    return np.bincount(np.asarray(draws), minlength=vocab) / len(draws)


@pytest.mark.parametrize('top_k', [0, 2])
def test_temperature_sampling_matches_jax_in_distribution(top_k):
    logits = np.array([[2.0, 1.0, 0.5, -1.0],
                       [0.0, 0.3, 0.1, 0.2]], np.float32)
    temps = np.array([0.7, 1.5], np.float32)
    gen = torch.Generator().manual_seed(0)
    t_draws = np.stack([
        tsampling.sample(torch.from_numpy(logits), gen,
                         torch.from_numpy(temps), top_k=top_k).numpy()
        for _ in range(N_DRAWS)])
    keys = jax.random.split(jax.random.PRNGKey(0), N_DRAWS)
    j_draws = np.asarray(jax.vmap(
        lambda k: jsampling.sample(jnp.asarray(logits), k,
                                   jnp.asarray(temps), top_k=top_k))(keys))
    for s in range(2):
        z = logits[s] / temps[s]
        if top_k:
            z = np.where(logits[s] < np.sort(logits[s])[-top_k], -np.inf,
                         z)
        p = np.exp(z - z.max())
        p /= p.sum()
        ft, fj = _freqs(t_draws[:, s], 4), _freqs(j_draws[:, s], 4)
        np.testing.assert_allclose(ft, p, atol=FREQ_TOL)
        np.testing.assert_allclose(fj, p, atol=FREQ_TOL)
        if top_k:
            assert np.all(ft[p == 0] == 0)


def test_mixed_greedy_and_sampled_slots():
    logits = torch.tensor([[0.0, 5.0, 1.0], [0.0, 5.0, 1.0]])
    gen = torch.Generator().manual_seed(1)
    for _ in range(20):
        out = tsampling.sample(logits, gen, torch.tensor([0.0, 100.0]))
        assert out[0].item() == 1


def test_sampling_params_validate():
    assert tsampling.SamplingParams().temperature == 0.0
    with pytest.raises(ValueError):
        tsampling.SamplingParams(temperature=-1.0)
