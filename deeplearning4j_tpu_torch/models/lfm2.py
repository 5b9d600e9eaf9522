"""LFM2-MoE (Liquid AI's ``Lfm2MoeForCausalLM``, the LFM2-8B-A1B family):
a decoder whose layers are gated short convolutions or grouped-query
attention, each followed by a dense SwiGLU (the first
``num_dense_layers``) or a sparse mixture of SwiGLU experts, on the
``MultiLayerNetwork`` (``nn/layers/decoder.py``).

The arguments carry the names of the model's ``config.json``.  Layers,
in order: the token embedding (layer 0), then for decoder layer ``j`` its
mixer (``ShortConvBlock`` or ``GroupedQueryAttentionBlock``, layer
``1 + 2j``) and its feed-forward (``SwiGLUBlock`` or ``MoEBlock``, layer
``2 + 2j``), the final RMSNorm and the head.  The head is a leaf of its
own (the published model ties it to the embedding).  Trained with Adam on
integer next-token labels; ``fit`` takes (batch, time) int32 or int64 ids
and labels.
"""

from __future__ import annotations

from typing import Sequence

from ..nn.conf.neural_net_configuration import (MultiLayerConfiguration,
                                                NeuralNetConfiguration)
from ..nn.layers.decoder import (GroupedQueryAttentionBlock, LMHeadLayer,
                                 MoEBlock, RMSNormLayer, SequenceEmbedding,
                                 ShortConvBlock, SwiGLUBlock)
from ..nn.weights import Distribution

#: the kernels' init scale (the config's ``initializer_range``)
INIT_STD = 0.02

#: LFM2-8B-A1B's 24 layers (its config.json)
LFM2_8B_A1B_LAYERS = (
    "conv", "conv", "full_attention", "conv", "conv", "conv",
    "full_attention", "conv", "conv", "conv", "full_attention", "conv",
    "conv", "conv", "full_attention", "conv", "conv", "conv",
    "full_attention", "conv", "conv", "full_attention", "conv", "conv")


def lfm2_moe(vocab_size: int = 65536, hidden_size: int = 2048,
             layer_types: Sequence[str] = LFM2_8B_A1B_LAYERS,
             num_dense_layers: int = 2, intermediate_size: int = 7168,
             moe_intermediate_size: int = 1792, num_experts: int = 32,
             num_experts_per_tok: int = 4, num_attention_heads: int = 32,
             num_key_value_heads: int = 8, conv_L_cache: int = 3,
             norm_eps: float = 1e-5, rope_theta: float = 1e6,
             routed_scaling_factor: float = 1.0,
             learning_rate: float = 1e-4, adam_mean_decay: float = 0.9,
             adam_var_decay: float = 0.95, seed: int = 123
             ) -> MultiLayerConfiguration:
    """The network of an LFM2-MoE ``config.json``; defaults are
    LFM2-8B-A1B's.  Kernels are drawn normal(0, ``INIT_STD``), norm
    weights start at one, ``expert_bias`` at zero."""
    d = hidden_size
    b = (NeuralNetConfiguration.builder()
         .seed(seed).updater("adam").learning_rate(learning_rate)
         .adam_mean_decay(adam_mean_decay).adam_var_decay(adam_var_decay)
         .weight_init("distribution")
         .dist(Distribution("normal", 0.0, INIT_STD))
         .activation("identity"))
    lb = b.list().layer(SequenceEmbedding(n_in=vocab_size, n_out=d))
    for j, kind in enumerate(layer_types):
        if kind == "conv":
            lb.layer(ShortConvBlock(n_in=d, eps=norm_eps,
                                    kernel=conv_L_cache))
        elif kind == "full_attention":
            lb.layer(GroupedQueryAttentionBlock(
                n_in=d, eps=norm_eps, n_heads=num_attention_heads,
                n_kv_heads=num_key_value_heads,
                head_dim=d // num_attention_heads, rope_theta=rope_theta))
        else:
            raise ValueError(f"layer type {kind!r} (conv or "
                             "full_attention)")
        if j < num_dense_layers:
            lb.layer(SwiGLUBlock(n_in=d, eps=norm_eps,
                                 width=intermediate_size))
        else:
            lb.layer(MoEBlock(n_in=d, eps=norm_eps,
                              width=moe_intermediate_size,
                              n_experts=num_experts,
                              top_k=num_experts_per_tok,
                              routed_scaling_factor=routed_scaling_factor))
    lb.layer(RMSNormLayer(n_in=d, eps=norm_eps))
    lb.layer(LMHeadLayer(n_in=d, n_out=vocab_size))
    return lb.build()
