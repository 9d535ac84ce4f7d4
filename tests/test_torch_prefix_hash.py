"""The port's copy of the chained prefix hashes
(``skypilot_tpu_torch/utils/prefix_hash.py``) against the JAX package's
(``skypilot_tpu/utils/prefix_hash.py``), on the same seeded token ids:
the serve load balancer parses these digests, so every link, chain,
fold, snapshot (full, delta, caught up, lapsed) and match depth must be
identical."""
import numpy as np
import pytest

from skypilot_tpu.utils import prefix_hash as jhash
from skypilot_tpu_torch.utils import prefix_hash as thash

pytestmark = pytest.mark.jax


def _tokens(seed, n):
    return [int(t) for t in np.random.default_rng(seed).integers(
        0, 128256, size=n)]


@pytest.mark.parametrize('page', [1, 16, 64])
@pytest.mark.parametrize('n', [0, 1, 63, 64, 65, 1040])
def test_chain_hashes_identical(page, n):
    toks = _tokens(page * 1000 + n, n)
    got = thash.chain_hashes(toks, page)
    assert got == jhash.chain_hashes(toks, page)
    assert len(got) == ((n - 1) // page if n else 0)
    for limit in (0, 1, 3):
        assert (thash.chain_hashes(toks, page, limit)
                == jhash.chain_hashes(toks, page, limit))


def test_block_hash_fold_and_match_depth_identical():
    rng = np.random.default_rng(3)
    parents = [0] + [int(x) for x in rng.integers(1, 2**63, size=5)]
    block = _tokens(4, 16)
    for p in parents:
        assert thash.block_hash(p, block) == jhash.block_hash(p, block)
    chain = thash.chain_hashes(_tokens(5, 300), 16)
    assert thash.fold_crc(chain) == jhash.fold_crc(chain)
    assert thash.fold_crc([]) == jhash.fold_crc([]) == 0
    for held in (set(), set(chain[:4]), set(chain), set(chain[1:])):
        assert (thash.match_depth(chain, held)
                == jhash.match_depth(chain, held))


@pytest.mark.parametrize('since', [-1, 0, 3, 6, 7, 9])
def test_build_snapshot_identical(since):
    chain = thash.chain_hashes(_tokens(6, 200), 16)
    journal = [(g, '+' if g % 3 else '-', chain[g % len(chain)])
               for g in range(3, 10)]
    for j in (journal, journal[2:], []):
        args = (9, thash.fold_crc(chain), 16, j, frozenset(chain), since)
        assert thash.build_snapshot(*args) == jhash.build_snapshot(*args)
