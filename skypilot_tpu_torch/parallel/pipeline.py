"""Pipeline parallelism: a GPipe microbatch pipeline over the ``pp`` group
(counterpart of ``skypilot_tpu/parallel/pipeline.py``).

Stages are contiguous layer groups, one a rank of ``pp``; activations go
to the next stage through ``collectives.ppermute`` and the schedule is the
reference's: ``M + P - 1`` ticks (the bubble), stage 0 injecting
microbatch ``t`` at tick ``t`` and the last stage emitting output ``t - (P
- 1)``. The backward pipeline comes from autograd through the shifts
(each shift's backward is the reverse shift), never from a hand-written
schedule. For that, every rank must run every shift's backward in the
same order, so the schedule picks its inputs and outputs with
tensor-level ``where`` (as the reference does), never with a Python
branch on the stage that would drop a shift from one rank's graph.

:func:`llama_pp_loss_fn` builds the loss of a Llama model over ``pp`` (and
``dp``): embed, final norm and ``lm_head`` computed on every stage, the
layers split over the stages (:func:`stage_params` cuts a rank's tree).
:func:`reduce_grads` finishes a rank's gradients: the embedding's grows
only on stage 0 and is summed over ``pp``; the head's and the final
norm's are the same whole gradient on every stage and are not; every
leaf's is summed over ``dp``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
import torch.utils.checkpoint

from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.ops import norms
from skypilot_tpu_torch.ops import rope as rope_lib
from skypilot_tpu_torch.parallel import collectives
from skypilot_tpu_torch.parallel.mesh import TPGroup


def _world(group: Optional[TPGroup]) -> int:
    return group.world if group is not None else 1


def pipeline_stages(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                    local_params: Any, microbatches: torch.Tensor,
                    group: Optional[TPGroup]) -> torch.Tensor:
    """Run ``microbatches`` [M, ...] through every stage of ``group``.

    ``stage_fn(local_params, x) -> y`` is this stage's compute (same
    shape). Every stage sees the whole microbatch list; stage 0 injects
    them, later stages take the previous stage's activations. Returns the
    [M, ...] outputs: the pipeline's on the last stage, zeros elsewhere
    (a sum over ``group`` broadcasts them)."""
    num_stages = _world(group)
    stage = group.rank if group is not None else 0
    M = microbatches.shape[0]
    shift = [(i, i + 1) for i in range(num_stages - 1)]
    first = torch.tensor(stage == 0, device=microbatches.device)
    state = torch.zeros_like(microbatches[0])
    outputs = [torch.zeros_like(microbatches[0]) for _ in range(M)]
    for t in range(M + num_stages - 1):
        x = torch.where(first, microbatches[min(t, M - 1)], state)
        y = stage_fn(local_params, x)
        out_idx = t - (num_stages - 1)
        ci = min(max(out_idx, 0), M - 1)
        valid = stage == num_stages - 1 and 0 <= out_idx < M
        outputs[ci] = torch.where(
            torch.tensor(valid, device=y.device), y, outputs[ci])
        state = collectives.ppermute(y, group, shift) \
            if num_stages > 1 else y
    return torch.stack(outputs)


def _llama_stage(config: llama.LlamaConfig, local_layers: Dict,
                 x: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor) -> torch.Tensor:
    """One stage: this stage's contiguous layer group in order, each
    layer under the config's remat (as ``llama.backbone``)."""
    remat_kw = llama._remat_kwargs(config) if config.remat else {}
    for values in zip(*(local_layers[k].unbind(0) for k in local_layers)):
        layer = dict(zip(local_layers, values))
        if config.remat:
            x = torch.utils.checkpoint.checkpoint(
                llama._layer, config, x, layer, cos, sin, None,
                use_reentrant=False, **remat_kw)
        else:
            x = llama._layer(config, x, layer, cos, sin, None)
    return x


def check_stages(config: llama.LlamaConfig, pp: int) -> None:
    """The reference's check: the layers split evenly over the stages."""
    if config.n_layers % pp != 0:
        raise ValueError(f'n_layers={config.n_layers} not divisible by '
                         f'pp={pp}')


def stage_params(params: llama.Params, stage: int, pp: int) -> llama.Params:
    """Stage ``stage``'s tree of a whole Llama tree: its contiguous
    ``n_layers / pp`` layers (copies) and the embed, final norm and head,
    which every stage holds whole."""
    n = next(iter(params['layers'].values())).shape[0] // pp
    layers = {k: v[stage * n:(stage + 1) * n].clone()
              for k, v in params['layers'].items()}
    return {**params, 'layers': layers}


def llama_pp_loss_fn(config: llama.LlamaConfig,
                     pp_group: Optional[TPGroup], num_microbatches: int,
                     dp_group: Optional[TPGroup] = None) -> Callable:
    """Build ``loss(params, tokens, targets)`` pipelined over
    ``pp_group``: ``params`` is this stage's tree (:func:`stage_params`),
    ``tokens``/``targets`` this ``dp`` rank's rows of the batch (all of it
    without ``dp_group``). The loss is the reference's plain one (fp32
    log-softmax, the mean over tokens), averaged over ``dp_group``; every
    rank returns the same value."""
    check_stages(config, _world(pp_group))

    def loss(params, tokens, targets):
        b = tokens.shape[0]
        if b % num_microbatches != 0:
            raise ValueError(f'per-dp batch {b} not divisible by '
                             f'M={num_microbatches}')
        x = params['embed'][tokens]                 # [b, s, d]
        cos, sin = rope_lib.rope_frequencies(config.head_dim,
                                             config.max_seq_len,
                                             config.rope_theta,
                                             device=x.device)
        mbs = x.reshape(num_microbatches, b // num_microbatches,
                        *x.shape[1:])
        outputs = pipeline_stages(
            lambda lp, h: _llama_stage(config, lp, h, cos, sin),
            params['layers'], mbs, pp_group)
        # Valid only on the last stage, zeros elsewhere: the sum
        # broadcasts (its backward is the identity on every stage).
        outputs = collectives.reduce_from(outputs, pp_group)
        h = outputs.reshape(b, *outputs.shape[2:])
        h = norms.rms_norm(h, params['final_norm'], config.norm_eps)
        logits = (h @ params['lm_head']).float()
        logp = torch.log_softmax(logits, dim=-1)
        nll = -logp.gather(-1, targets[..., None].long())[..., 0]
        out = nll.mean()
        if _world(dp_group) > 1:
            out = collectives.reduce_from(out, dp_group) / dp_group.world
        return out

    return loss


def reduce_grads(grads: llama.Params, pp_group: Optional[TPGroup],
                 dp_group: Optional[TPGroup] = None) -> llama.Params:
    """A stage's gradients of the global loss from its own: the
    embedding's summed over ``pp`` (only stage 0 reads it), every leaf's
    summed over ``dp``."""
    def finish(node):
        if isinstance(node, dict):
            return {k: finish(v) for k, v in node.items()}
        return collectives.all_reduce_sum(node, dp_group)
    return finish({**grads, 'embed': collectives.all_reduce_sum(
        grads['embed'], pp_group)})
