"""The port's replica tokenizer against the JAX server's, on the CPU.

- On the in-repo ``examples/tokenizer_8k.json`` (HuggingFace
  ``tokenizers`` format): the same ids and text as the JAX
  ``Tokenizer``, real subwords, and a round trip (the reference's own
  checks).
- A vocabulary over the model's limit, a missing ``tokenizers`` package
  and a ``.model`` file without ``sentencepiece`` exit with the JAX
  server's messages word for word.
- The streamed text (``IncrementalDecoder``, one token at a time, then
  the flush) equals a one-shot decode, and the JAX decoder's deltas.
- The byte fallback round-trips UTF-8 and drops ids past 255, as JAX's.
"""
import pathlib
import sys

import pytest

from skypilot_tpu.infer import server as jserver
from skypilot_tpu_torch.infer import server as tserver

pytestmark = pytest.mark.jax

PATH = str(pathlib.Path(__file__).resolve().parents[1] / 'examples'
           / 'tokenizer_8k.json')
TEXTS = ['Launch a v5p-64 slice and gang-schedule the job.',
         'naïve café — 東京 🚀 spot-preempted replicas resume',
         '', '   leading and trailing   ', 'x' * 300]


def test_ids_and_text_equal_jax():
    jt = jserver.Tokenizer(PATH, vocab_limit=32768)
    tt = tserver.Tokenizer(PATH, vocab_limit=32768)
    assert tt.kind == jt.kind == 'hf'
    for text in TEXTS:
        ids = tt.encode(text)
        assert ids == jt.encode(text)
        assert all(isinstance(i, int) for i in ids)
        assert tt.decode(ids) == jt.decode(ids)
    ids = tt.encode(TEXTS[0])
    assert ids and len(ids) < len(TEXTS[0]) // 2   # subwords, not bytes
    assert tt.decode(ids) == TEXTS[0]


def _exit_message(cls, *args, **kwargs) -> str:
    with pytest.raises(SystemExit) as info:
        cls(*args, **kwargs)
    return str(info.value)


def test_refusals_match_jax_word_for_word(monkeypatch):
    msg = _exit_message(tserver.Tokenizer, PATH, vocab_limit=256)
    assert 'vocab' in msg
    assert msg == _exit_message(jserver.Tokenizer, PATH, vocab_limit=256)
    # No sentencepiece here: a .model path exits the same way.
    monkeypatch.setitem(sys.modules, 'sentencepiece', None)
    msg = _exit_message(tserver.Tokenizer, 'tok.model')
    assert msg == _exit_message(jserver.Tokenizer, 'tok.model')
    assert 'sentencepiece' in msg
    # A .json path without the tokenizers package.
    monkeypatch.setitem(sys.modules, 'tokenizers', None)
    msg = _exit_message(tserver.Tokenizer, PATH)
    assert msg == _exit_message(jserver.Tokenizer, PATH)
    assert "'tokenizers'" in msg


@pytest.mark.parametrize('path', [PATH, None])
def test_streamed_text_equals_one_shot_decode(path):
    tt = tserver.Tokenizer(path, vocab_limit=32768)
    jt = jserver.Tokenizer(path, vocab_limit=32768)
    for text in TEXTS[:2]:
        ids = tt.encode(text)
        tdec = tserver.IncrementalDecoder(tt)
        jdec = jserver.IncrementalDecoder(jt)
        tparts = [tdec.feed(ids, n) for n in range(1, len(ids) + 1)]
        jparts = [jdec.feed(ids, n) for n in range(1, len(ids) + 1)]
        tparts.append(tdec.flush(ids))
        jparts.append(jdec.flush(ids))
        assert tparts == jparts
        assert ''.join(tparts) == tt.decode(ids) == text


def test_byte_fallback_matches_jax():
    tt, jt = tserver.Tokenizer(), jserver.Tokenizer()
    assert tt.kind == jt.kind == 'bytes'
    for text in TEXTS:
        assert tt.encode(text) == jt.encode(text)
    ids = [104, 105, 300, -1, 0xE6, 0x9D]
    assert tt.decode(ids) == jt.decode(ids)
