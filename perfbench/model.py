"""The port's model configuration for a configuration file.

The file keeps Hugging Face's key names; the port's ``LlamaConfig``
names them its own way (``dim``, ``n_layers``, ``n_heads``,
``n_kv_heads``, ``ffn_dim``, ``norm_eps``). Imported only by processes
that run the port.
"""
from __future__ import annotations

from typing import Any, Dict, Optional


def llama_config(config: Dict[str, Any], max_seq_len: Optional[int] = None,
                 **train):
    """``LlamaConfig`` of ``config``; ``max_seq_len`` defaults to the
    published context, ``train`` sets the training fields (remat,
    ``loss_vocab_chunks``, ...)."""
    from skypilot_tpu_torch.models import llama
    if config['hidden_size'] // config['num_attention_heads'] \
            != config['head_dim']:
        raise ValueError('the port derives head_dim as hidden_size / '
                         'num_attention_heads')
    return llama.LlamaConfig(
        vocab_size=config['vocab_size'], dim=config['hidden_size'],
        n_layers=config['num_hidden_layers'],
        n_heads=config['num_attention_heads'],
        n_kv_heads=config['num_key_value_heads'],
        ffn_dim=config['intermediate_size'],
        max_seq_len=max_seq_len or config['max_position_embeddings'],
        rope_theta=float(config['rope_theta']),
        norm_eps=float(config['rms_norm_eps']),
        dtype=config['torch_dtype'], **train)
