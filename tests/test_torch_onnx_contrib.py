"""synapseml_torch's ``com.microsoft`` contrib ops (ONNX Runtime's
transformer fusions) against the JAX package's, and a fused BERT encoder.

One-node models of each contrib op (the ``com.microsoft`` domain) run
through both converters on the CPU on the same numpy inputs, within 1e-5
(f32); ``Attention`` with every mask form the reference takes, causal, a
custom scale and an additive bias; the refusals match the reference's.
``chip_smoke.py``'s ORT-fused BERT graph (EmbedLayerNormalization, then
Attention, the output projection, SkipLayerNormalization, MatMul +
BiasGelu, MatMul, SkipLayerNormalization a layer), built from a bert-tiny
state_dict, is held to the port's own encoder on the same weights (5e-6)
and to the JAX converter (1e-5), and the reference's fused block to a
numpy oracle. The reference is ``synapseml_tpu/onnx/contrib.py``.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))
from _torch_onnx_graphs import (I64, assert_same, f32, jax, model_bytes, node,  # noqa: E402
                                port, vi)

TOL = 1e-5
B, S, HIN, HEADS = 2, 6, 8, 2
RAW = np.array([[1, 1, 1, 1, 1, 0], [1, 1, 1, 0, 0, 0]], I64)


def _ms_case(op, inputs, attrs=None, init=(), n_out=1, id=None):
    return pytest.param(op, inputs, attrs or {}, init, n_out, id=id or op)


X = f32(B, S, HIN, seed=1)
W_QKV = f32(HIN, 3 * HIN, seed=2, scale=0.3)
B_QKV = f32(3 * HIN, seed=3)
EMB = dict(ids=np.random.default_rng(4).integers(0, 20, (B, S)).astype(I64),
           seg=np.random.default_rng(5).integers(0, 2, (B, S)).astype(I64),
           word=f32(20, HIN, seed=6), pos=f32(S + 2, HIN, seed=7), segemb=f32(2, HIN, seed=8),
           gamma=f32(HIN, seed=9), beta=f32(HIN, seed=10))

CONTRIB_CASES = [
    _ms_case("FastGelu", [X, f32(HIN, seed=11)], id="fast-gelu-bias"),
    _ms_case("FastGelu", [X], id="fast-gelu"),
    _ms_case("BiasGelu", [X, f32(HIN, seed=11)], init=(1,)),
    _ms_case("QuickGelu", [X], dict(alpha=1.702)),
    _ms_case("QuickGelu", [X], dict(alpha=1.3), id="quick-gelu-alpha"),
    _ms_case("SkipLayerNormalization", [X, f32(B, S, HIN, seed=12), EMB["gamma"], EMB["beta"],
                                        f32(HIN, seed=13)], dict(epsilon=1e-12), init=(2, 3, 4),
             n_out=4, id="skip-layer-norm-bias-every-output"),
    _ms_case("SkipLayerNormalization", [X, f32(B, S, HIN, seed=12), EMB["gamma"]], n_out=1,
             id="skip-layer-norm-no-beta"),
    _ms_case("EmbedLayerNormalization",
             [EMB["ids"], EMB["seg"], EMB["word"], EMB["pos"], EMB["segemb"], EMB["gamma"],
              EMB["beta"], RAW], init=(2, 3, 4, 5, 6), n_out=3, id="embed-layer-norm-mask"),
    _ms_case("EmbedLayerNormalization",
             [EMB["ids"], None, EMB["word"], EMB["pos"], None, EMB["gamma"], EMB["beta"], None,
              np.array([[5, 6, 7, 0, 1, 2], [0, 1, 2, 3, 4, 5]], I64)],
             init=(2, 3, 5, 6), n_out=3, id="embed-layer-norm-position-ids"),
    _ms_case("FusedMatMul", [f32(3, 4), f32(5, 4, seed=1)], dict(transB=1, alpha=0.5),
             id="fused-matmul-transb-alpha"),
    _ms_case("FusedMatMul", [f32(2, 4, 3), f32(2, 4, 5, seed=1)], dict(transA=1),
             id="fused-matmul-batched-transa"),
    *(_ms_case("Attention", [X, W_QKV, B_QKV] + m, dict(num_heads=HEADS, unidirectional=u),
               init=(1, 2), id=f"attention-{tag}-unidirectional{u}")
      for u in (0, 1)
      for tag, m in (("no-mask", []), ("raw-2d", [RAW]),
                     ("lengths", [RAW.sum(1).astype(np.int32)]))),
    _ms_case("Attention", [X[:1, :4], W_QKV, np.zeros(3 * HIN, np.float32)],
             dict(num_heads=2, scale=0.125), id="attention-custom-scale"),
    _ms_case("Attention", [X[:1, :4], W_QKV, B_QKV, None, None, f32(1, 2, 4, 4, seed=14)],
             dict(num_heads=2), id="attention-additive-bias"),
    _ms_case("Attention", [X, W_QKV, B_QKV, RAW], dict(num_heads=2, qkv_hidden_sizes=[8, 8, 8]),
             id="attention-equal-qkv-sizes"),
]


@pytest.mark.parametrize("op,inputs,attrs,init,n_out", CONTRIB_CASES)
def test_contrib_op_matches_jax(op, inputs, attrs, init, n_out):
    data, feeds = model_bytes(op, inputs, attrs, n_out, init, domain="com.microsoft")
    assert_same(port(data, feeds), jax(data, feeds), TOL, op)


@pytest.mark.parametrize("op,inputs,attrs,msg", [
    ("Attention", [X[:, :2, :4], f32(4, 12), np.zeros(12, np.float32)],
     dict(num_heads=1, do_rotary=1), "rotary"),
    ("Attention", [X[:, :2, :4], f32(4, 12), np.zeros(12, np.float32), None,
                   np.zeros((2, 1, 1, 2, 2), np.float32)], dict(num_heads=1), "past"),
    ("Attention", [X, W_QKV, B_QKV], dict(num_heads=2, qkv_hidden_sizes=[8, 8, 4]), "unequal"),
    ("Attention", [X, W_QKV, B_QKV, np.ones((B, 1, S, S), I64)], dict(num_heads=2), "rank 4"),
    ("FusedMatMul", [X, X], dict(transBatchA=1), "transBatch"),
])
def test_refusals_match_the_reference(op, inputs, attrs, msg):
    data, feeds = model_bytes(op, inputs, attrs, domain="com.microsoft")
    for run in (port, jax):
        with pytest.raises(NotImplementedError, match=msg):
            run(data, feeds)


def _np_layernorm(h, gamma, beta, eps=1e-12):
    mean = h.mean(-1, keepdims=True)
    return (h - mean) / np.sqrt(((h - mean) ** 2).mean(-1, keepdims=True) + eps) * gamma + beta


def test_fused_bert_block_graph_matches_jax_and_a_numpy_oracle():
    """The reference's fused block: EmbedLayerNormalization -> Attention ->
    SkipLayerNormalization -> FusedMatMul + BiasGelu -> FusedMatMul ->
    SkipLayerNormalization as one graph."""
    from scipy.special import erf

    from synapseml_torch.onnx import proto as P

    rs = np.random.default_rng(0)
    V, H, F = 30, 8, 16
    ids = rs.integers(0, V, (2, S)).astype(I64)
    mask = np.array([[1] * 6, [1, 1, 1, 1, 0, 0]], I64)
    w = {"word": rs.normal(size=(V, H)) * 0.5, "pos": rs.normal(size=(S, H)) * 0.5,
         "g1": np.ones(H), "b1": np.zeros(H), "wq": rs.normal(size=(H, 3 * H)) * 0.3,
         "bq": np.zeros(3 * H), "g2": np.ones(H), "b2": np.zeros(H),
         "w_up": rs.normal(size=(H, F)) * 0.3, "b_up": rs.normal(size=F),
         "w_dn": rs.normal(size=(F, H)) * 0.3, "g3": np.ones(H), "b3": np.zeros(H)}
    w = {k: v.astype(np.float32) for k, v in w.items()}
    ms = "com.microsoft"
    g = P.GraphProto(
        name="fused_bert_block",
        node=[node("EmbedLayerNormalization", ["ids", "", "word", "pos", "", "g1", "b1", "mask"],
                   ["emb", "mask_idx"], ms, epsilon=1e-12),
              node("Attention", ["emb", "wq", "bq", "mask"], ["attn"], ms, num_heads=2),
              node("SkipLayerNormalization", ["attn", "emb", "g2", "b2"], ["h1"], ms,
                   epsilon=1e-12),
              node("FusedMatMul", ["h1", "w_up"], ["up"], ms),
              node("BiasGelu", ["up", "b_up"], ["act"], ms),
              node("FusedMatMul", ["act", "w_dn"], ["down"], ms),
              node("SkipLayerNormalization", ["down", "h1", "g3", "b3"], ["out"], ms,
                   epsilon=1e-12)],
        initializer=[P.numpy_to_tensor(v, k) for k, v in w.items()],
        input=[vi("ids", P.INT64, ["B", S]), vi("mask", P.INT64, ["B", S])],
        output=[vi("out", P.FLOAT, ["B", S, H])])
    data = P.ModelProto(graph=g).encode()
    feeds = {"ids": ids, "mask": mask}
    ours = port(data, feeds)
    assert_same(ours, jax(data, feeds), TOL)

    def attention(x):
        q, k, v = (t.reshape(2, S, 2, 4).transpose(0, 2, 1, 3)
                   for t in np.split(x @ w["wq"], 3, -1))
        s = np.where(mask[:, None, None, :] > 0, np.einsum("bnqd,bnkd->bnqk", q, k) / 2.0, -1e30)
        p = np.exp(s - s.max(-1, keepdims=True))
        p /= p.sum(-1, keepdims=True)
        return np.einsum("bnqk,bnkd->bnqd", p, v).transpose(0, 2, 1, 3).reshape(2, S, H)

    emb = _np_layernorm(w["word"][ids] + w["pos"][None], w["g1"], w["b1"])
    h1 = _np_layernorm(attention(emb) + emb, w["g2"], w["b2"])
    up = h1 @ w["w_up"] + w["b_up"]
    act = 0.5 * up * (1 + erf(up / np.sqrt(2)))
    want = _np_layernorm(act @ w["w_dn"] + h1, w["g3"], w["b3"])
    np.testing.assert_allclose(ours["out"], want, rtol=1e-4, atol=1e-5)


def test_chip_smokes_ort_fused_bert_matches_the_ports_encoder_and_jax():
    """chip_smoke.py main path 10 (a)'s graph builder at bert-tiny: its
    ORT-form graph against the port's BERT encoder on the same weights
    (f32, 5e-6) and against the JAX converter (1e-5), with padded rows."""
    sys.path.insert(0, str(Path(__file__).parent.parent))
    import chip_smoke

    from synapseml_torch.models.convert_jax import bert_state_dict_from_flax, init_flax_bert_params
    from synapseml_torch.models.nets.bert import bert_tiny

    cfg = bert_tiny()
    params = bert_state_dict_from_flax(init_flax_bert_params(cfg, num_classes=2, seed=0))
    data = chip_smoke._fused_bert_bytes(params, cfg)
    rs = np.random.default_rng(1)
    ids = rs.integers(2, cfg.vocab_size, (3, 16)).astype(I64)
    mask = (np.arange(16)[None] < np.array([[16], [9], [3]])).astype(I64)
    ids *= mask
    feeds = {"input_ids": ids, "segment_ids": np.zeros_like(ids), "mask": mask}
    ours = port(data, feeds)
    native = chip_smoke._native_bert_encoder(params, cfg, torch.device("cpu"))
    want = native(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(ours["hidden"], want, rtol=5e-6, atol=5e-6)
    assert_same(ours, jax(data, feeds), TOL)
