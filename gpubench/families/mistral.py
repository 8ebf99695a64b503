"""``model_type`` ``mistral``: a Llama-shaped decoder, run through the port's
Llama path (``nanotpu_torch.models.llama``) and held against
:mod:`gpubench.reference.dense`."""

from __future__ import annotations

from gpubench.reference import dense


def port(conf: dict):
    """(the port's config, its training loss) for ``conf``; the attention
    of prefill and training through the flash kernels."""
    from nanotpu_torch.models import llama

    heads = conf["num_attention_heads"]
    if conf.get("head_dim", conf["hidden_size"] // heads) * heads != conf["hidden_size"]:
        raise ValueError("the port's Llama path takes head_dim = hidden_size / heads")
    if conf.get("sliding_window") or conf.get("tie_word_embeddings") \
            or conf["hidden_act"] != "silu":
        raise ValueError("the port's Llama path has no sliding window, no "
                         "tied head and only the SiLU gate")
    cfg = llama.LlamaConfig(
        vocab_size=conf["vocab_size"], dim=conf["hidden_size"],
        n_layers=conf["num_hidden_layers"], n_heads=heads,
        n_kv_heads=conf["num_key_value_heads"],
        ffn_dim=conf["intermediate_size"],
        max_seq_len=conf["max_position_embeddings"],
        rope_theta=float(conf["rope_theta"]), norm_eps=conf["rms_norm_eps"],
        dtype=conf["torch_dtype"], attn_impl="flash")
    return cfg, llama.loss_fn


reference_logits = dense.logits
reference_loss = dense.loss
