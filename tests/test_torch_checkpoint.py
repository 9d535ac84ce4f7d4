"""The port's checkpoint manager (``skypilot_tpu_torch/train/checkpoint.py``):
save and restore of a train state, the Orbax save rule (first save,
interval, no step at or below the latest, ``force``), ``max_to_keep``
and ``restore_or_init``; ``restore_to_host`` then ``quantize_params``
onto an explicit device against ``quantize_params`` of the saved tree
(the reference's check), and the replica's ``--checkpoint`` (a ``train.run`` state or a
bare params tree, with and without ``--quantize``). Everything runs on
the CPU in a temporary directory; values must come back bit for bit.
"""
import os

import pytest
import torch

from skypilot_tpu_torch.infer import server as tserver
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.ops import quant
from skypilot_tpu_torch.train import checkpoint as ckpt
from skypilot_tpu_torch.train import trainer


def _state(seed=0):
    opt = trainer.make_optimizer(mu_dtype='bfloat16')
    return trainer.init_train_state(llama.LlamaConfig.tiny(),
                                    torch.Generator().manual_seed(seed), opt)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _equal(a, b):
    assert int(a.step) == int(b.step)
    for x, y in zip(_leaves(a.params) + _leaves(a.opt_state),
                    _leaves(b.params) + _leaves(b.opt_state)):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_save_and_restore_round_trip(tmp_path):
    tmp_path = tmp_path / 'ckpt'
    mgr = ckpt.CheckpointManager(str(tmp_path))
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore()
    state = _state()
    state.step = torch.tensor(7, dtype=torch.int32)
    assert mgr.save(7, state)
    mgr.wait()
    assert mgr.latest_step() == 7
    assert sorted(os.listdir(tmp_path)) == ['7']
    _equal(mgr.restore(), state)
    _equal(mgr.restore(7, target=_state(seed=1)), state)
    with pytest.raises(ValueError, match='does not match'):
        mgr.restore(target=trainer.init_train_state(
            llama.LlamaConfig.tiny(dim=32), torch.Generator().manual_seed(0),
            trainer.make_optimizer()))
    mgr.close()


def test_interval_first_save_and_force(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path), save_interval_steps=2,
                                 max_to_keep=10)
    state = _state()
    saved = [step for step in range(1, 6) if mgr.save(step, state)]
    # Step 1 is the first save; then every second step.
    assert saved == [1, 2, 4]
    assert not mgr.save(4, state)          # at the latest step
    assert not mgr.save(3, state)          # below it
    assert mgr.save(5, state, force=True)
    with pytest.raises(ValueError, match='already exists'):
        mgr.save(5, state, force=True)
    assert mgr.all_steps() == [1, 2, 4, 5]


def test_max_to_keep_deletes_the_oldest(tmp_path):
    tmp_path = tmp_path / 'ckpt'
    mgr = ckpt.CheckpointManager(str(tmp_path), max_to_keep=2)
    state = _state()
    for step in range(1, 5):
        assert mgr.save(step, state)
    assert mgr.all_steps() == [3, 4]
    assert sorted(os.listdir(tmp_path)) == ['3', '4']


def test_restore_or_init(tmp_path):
    calls = []

    def init():
        calls.append(1)
        return _state()

    state, restored = ckpt.restore_or_init(str(tmp_path), init)
    assert not restored and len(calls) == 1
    state.step = torch.tensor(3, dtype=torch.int32)
    state.params['final_norm'].fill_(2.0)
    ckpt.CheckpointManager(str(tmp_path)).save(3, state)
    again, restored = ckpt.restore_or_init(str(tmp_path), init)
    assert restored
    _equal(again, state)


def _qleaves(tree):
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out += _qleaves(v)
        elif isinstance(v, quant.QuantArray):
            out += [v.q, v.scale]
        else:
            out.append(v)
    return out


def test_restore_to_host_and_transfer_quantize(tmp_path):
    """The --quantize --checkpoint path: the saved tree comes back on the
    host (checked against a meta-device target), then quantizes leaf by
    leaf onto an explicit device, bitwise quantize_params of the saved
    params; a target of another shape is refused."""
    cfg = llama.LlamaConfig.tiny()
    p = llama.init_params(cfg, torch.Generator().manual_seed(0))
    mgr = ckpt.CheckpointManager(str(tmp_path / 'ck'))
    mgr.save(0, {'params': p})
    abstract = llama.init_params(cfg, None, 'meta')
    host = mgr.restore_to_host({'params': abstract})['params']
    assert all(t.device.type == 'cpu' for t in _leaves(host))
    qp = quant.quantize_params(host, 'cpu')
    ref = quant.quantize_params(p)
    for a, b in zip(_qleaves(qp), _qleaves(ref)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    other = llama.init_params(llama.LlamaConfig.tiny(dim=32, n_heads=2,
                                                     n_kv_heads=1),
                              None, 'meta')
    with pytest.raises(ValueError, match='does not match'):
        mgr.restore_to_host({'params': other})
    with pytest.raises(ValueError, match='keys'):
        mgr.restore_to_host(abstract)


@pytest.mark.parametrize('quantize', [True, False])
def test_replica_serves_a_train_run_checkpoint(tmp_path, quantize):
    """--checkpoint over a directory train.run wrote (a TrainState that
    nests the params), and over a bare params tree: the replica's
    weights are the saved params (quantized onto the device by
    quantize_params with --quantize), and its greedy tokens an engine's on them."""
    state = _state(3)
    ckpt.CheckpointManager(str(tmp_path / 'run')).save(2, state)
    ckpt.CheckpointManager(str(tmp_path / 'bare')).save(0, state.params)
    flags = ['--port', '0', '--model', 'tiny', '--slots', '2',
             '--max-seq-len', '128', '--page-size', '16', '--device', 'cpu',
             '--paged']
    want = (quant.quantize_params(state.params) if quantize
            else state.params)
    for name in ('run', 'bare'):
        args = tserver.parse_args(flags + ['--checkpoint',
                                           str(tmp_path / name)]
                                  + (['--quantize'] if quantize else []))
        got = tserver.load_params(args, llama.LlamaConfig.tiny())
        for a, b in zip(_qleaves(got), _qleaves(want)):
            assert a.dtype == b.dtype and torch.equal(a, b)
    srv = tserver.server_from_args(args)
    ref = tserver.build_engine('tiny', 2, 128, 16, None, 'cpu', paged=True,
                               quantize=quantize, params=want)
    prompt = [7, 3, 99, 12, 5]
    [a] = srv.engine.generate([prompt], max_new_tokens=6)
    [b] = ref.generate([prompt], max_new_tokens=6)
    assert a.output_tokens == b.output_tokens
    wrong = tserver.parse_args(
        ['--port', '0', '--model', '350m', '--device', 'cpu',
         '--checkpoint', str(tmp_path / 'run')])
    with pytest.raises(ValueError, match='does not match'):
        tserver.load_params(wrong, llama.LlamaConfig.bench_350m())
