"""``model_type`` ``mixtral``: the port's Mixtral
(``nanotpu_torch.models.mixtral``), held against
:mod:`gpubench.reference.moe`.

A configuration with no ``assumed.capacity_factor`` is the published,
dropless model: the port gets the capacity factor E / top_k, at which its
Switch capacity ceil(cf * T * top_k / E) is T, a slot an expert for every
token, so that no choice is dropped; the training loss routes at it too.
The serving check's forward is dropless whatever the configuration
states."""

from __future__ import annotations

from gpubench.reference import moe


def capacity_factor(conf: dict) -> float:
    """The stated capacity factor, or the dropless E / top_k."""
    dropless = conf["num_local_experts"] / conf["num_experts_per_tok"]
    return conf.get("assumed", {}).get("capacity_factor", dropless)


def port(conf: dict):
    """(the port's config, its training loss) for ``conf``; attention
    through the flash kernels, capacity (:func:`capacity_factor`) and the
    load-balancing weight as the configuration states them."""
    from nanotpu_torch.models import mixtral

    if conf.get("sliding_window") or conf.get("tie_word_embeddings") \
            or conf["hidden_act"] != "silu":
        raise ValueError("the port's Mixtral has no sliding window, no tied "
                         "head and only the SiLU gate")
    cfg = mixtral.MixtralConfig(
        vocab_size=conf["vocab_size"], dim=conf["hidden_size"],
        n_layers=conf["num_hidden_layers"],
        n_heads=conf["num_attention_heads"],
        n_kv_heads=conf["num_key_value_heads"],
        ffn_dim=conf["intermediate_size"],
        n_experts=conf["num_local_experts"], top_k=conf["num_experts_per_tok"],
        capacity_factor=capacity_factor(conf),
        max_seq_len=conf["max_position_embeddings"],
        rope_theta=float(conf["rope_theta"]), norm_eps=conf["rms_norm_eps"],
        dtype=conf["torch_dtype"], attn_impl="flash",
        router_aux_weight=conf["router_aux_loss_coef"])
    return cfg, mixtral.loss_fn


def reference_loss(params: dict, conf: dict, tokens, num=None):
    return moe.loss(params, conf, tokens, capacity_factor(conf), num)


reference_logits = moe.logits
