"""A dense decoder's leaves in the port's layout, counted from the
configuration's published keys, and the FL round over whole clients."""
import math

from portbench.cost import kernels


def leaves(cfg: dict) -> dict:
    """``{name: shape}`` of one model: the layers' leaves stacked on a
    leading layer axis, as ``repro_torch.models.transformer`` lays them
    out (the port's leaf names); the embedding tied to the output head
    where ``tie_word_embeddings``."""
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    n, v = cfg["num_hidden_layers"], cfg["vocab_size"]
    h, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg.get("head_dim") or d // h
    out = {"embed": (v, d), "final_norm": (d,), "blocks/ln1": (n, d),
           "blocks/attn/wq": (n, d, h * hd), "blocks/attn/wk": (n, d, kv * hd),
           "blocks/attn/wv": (n, d, kv * hd), "blocks/attn/wo": (n, h * hd, d)}
    if cfg.get("qkv_bias"):
        out.update({"blocks/attn/bq": (n, h * hd), "blocks/attn/bk": (n, kv * hd),
                    "blocks/attn/bv": (n, kv * hd)})
    out.update({"blocks/ln2": (n, d), "blocks/mlp/w_gate": (n, d, f),
                "blocks/mlp/w_up": (n, d, f), "blocks/mlp/w_down": (n, f, d)})
    if not cfg["tie_word_embeddings"]:
        out["lm_head"] = (d, v)
    return out


def param_count(cfg: dict) -> int:
    return sum(math.prod(s) for s in leaves(cfg).values())


def feature_leaf(cfg: dict) -> str:
    """The K-means feature block: ``lm_head``, or the tied ``embed``."""
    return "embed" if cfg["tie_word_embeddings"] else "lm_head"


def round_calls(cfg: dict, n: int, c: int, elem_bytes: int = 2,
                winners: int = None) -> list:
    """The hand-kernel calls one round over ``n`` stacked clients needs:
    each leaf's divergence against the global row (one centroid), the
    K-means distances of the feature block against ``c`` fp32 centroids,
    each leaf's fold over the ``winners`` selected clients (one a
    non-empty cluster; ``c`` by default)."""
    winners = c if winners is None else winners
    calls = []
    for shape in leaves(cfg).values():
        calls.append(("pairwise_l2", dict(n=n, m=1, f=math.prod(shape),
                                          x_bytes=elem_bytes, c_bytes=4)))
    feat = math.prod(leaves(cfg)[feature_leaf(cfg)])
    calls.append(("pairwise_l2", dict(n=n, m=c, f=feat, x_bytes=elem_bytes,
                                      c_bytes=4)))
    for shape in leaves(cfg).values():
        calls.append(("flat_aggregate", dict(n=n, p=math.prod(shape),
                                             x_bytes=elem_bytes,
                                             live=winners)))
    return calls


def fl_round(cfg: dict, n: int, c: int, elem_bytes: int = 2):
    """``(flops, bytes)`` one round needs: the clients, the global row and
    the centroids read once, the new global row written once (in the
    clients' type), the divergences and labels; the operations of the
    divergence, the K-means distances and the fold."""
    p = param_count(cfg)
    feat = math.prod(leaves(cfg)[feature_leaf(cfg)])
    flops = sum(kernels.cost(call)[0] for call in round_calls(cfg, n, c,
                                                              elem_bytes))
    nbytes = (n * p * elem_bytes + p * elem_bytes + c * feat * 4
              + p * elem_bytes + n * 4 + n * 8 + n * 4)
    return flops, nbytes
