"""Chained page-block prefix hashes: the fleet KV index key space (a
copy of ``skypilot_tpu/utils/prefix_hash.py``; the port imports nothing of
the JAX package, and the load balancer parses these digests, so they
must stay byte-identical to the reference's).

The radix prefix cache (infer/prefix_cache.py) keys nodes on raw token
tuples; that is exact but unbounded on the wire. The fleet index at the
load balancer needs a COMPACT, order-preserving digest of "this replica
holds the first N pages of prompt P" that both sides can compute
independently: the replica from its radix tree, the LB from an incoming
request's token ids. A chained hash gives exactly that:

    h_0 = H(root_seed || tokens[0:page])
    h_i = H(h_{i-1}   || tokens[i*page:(i+1)*page])

so ``h_i`` commits to the ENTIRE prefix through page ``i``, not just
block ``i`` — two prompts share ``h_i`` iff they share the first
``(i+1)*page`` tokens (modulo 64-bit collision, whose worst case is one
wasted transfer attempt that degrades to recompute; correctness never
rides on the hash).

hashlib only: a torch replica, a JAX replica and the serve load balancer
compute the same digests from the same token ids.
"""
from __future__ import annotations

import hashlib
from typing import List, Sequence, Tuple

# 8-byte digests: the index holds ~thousands of entries per replica, so
# 64 bits keeps collision odds negligible while the on-wire summary
# stays compact (the whole point of hashing instead of shipping tokens).
_DIGEST_BYTES = 8
_ROOT_SEED = b'sky-tpu/kv-prefix/v1'


def _h(parent: bytes, block: Sequence[int]) -> bytes:
    d = hashlib.blake2b(digest_size=_DIGEST_BYTES)
    d.update(parent)
    d.update(','.join(str(int(t)) for t in block).encode())
    return d.digest()


def block_hash(parent: int, block: Sequence[int]) -> int:
    """One chain link: the digest committing to ``parent``'s prefix
    extended by ``block``. ``parent`` is 0 at the root."""
    seed = _ROOT_SEED if parent == 0 else int(parent).to_bytes(
        _DIGEST_BYTES, 'big')
    return int.from_bytes(_h(seed, block), 'big')


def chain_hashes(tokens: Sequence[int], page: int,
                 limit: int = -1) -> List[int]:
    """Chain digests for each FULL page of ``tokens``, capped at the
    last full page strictly before the prompt end — the same boundary
    rule as PrefixCache.match, so an LB-side chain lines up one-to-one
    with the radix path a replica would index.

    ``limit`` (when >= 0) caps the number of blocks hashed — the LB
    bounds per-request work with it.
    """
    n_full = (len(tokens) - 1) // page if tokens else 0
    if limit >= 0:
        n_full = min(n_full, limit)
    out: List[int] = []
    parent = 0
    for i in range(n_full):
        parent = block_hash(parent, tokens[i * page:(i + 1) * page])
        out.append(parent)
    return out


def fold_crc(hashes: Sequence[int]) -> int:
    """Order-independent checksum of an index's hash SET (XOR fold):
    the LB verifies a delta-maintained mirror against the replica's
    self-reported value and forces a full resync on mismatch."""
    acc = 0
    for h in hashes:
        acc ^= int(h)
    return acc


def build_snapshot(gen: int, crc: int, page: int,
                   journal: Sequence[Tuple[int, str, int]],
                   hashes, since_gen: int) -> dict:
    """The on-wire radix summary, delta-encoded when the (gen, op,
    hash) journal still covers ``since_gen`` — every op bumps the
    generation by exactly one, so coverage is checkable from the oldest
    retained entry alone. Falls back to the full (sorted — the wire
    must be deterministic) hash list on a cold or lapsed consumer."""
    snap: dict = {'gen': gen, 'crc': crc, 'page': page}
    if since_gen == gen:
        snap['delta'] = []
    elif (0 <= since_gen < gen and journal
          and journal[0][0] <= since_gen + 1):
        snap['delta'] = [[op, h] for g, op, h in journal
                         if g > since_gen]
    else:
        snap['full'] = sorted(hashes)
    return snap


def match_depth(chain: Sequence[int], held: 'set | frozenset') -> int:
    """Longest indexed prefix: how many leading links of ``chain`` are
    in ``held``. Chained hashes make the held set prefix-closed per
    donor, so the first miss ends the match."""
    depth = 0
    for h in chain:
        if h not in held:
            break
        depth += 1
    return depth
