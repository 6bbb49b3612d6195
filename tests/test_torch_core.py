"""synapseml_torch.core and the tokenizer against synapseml_tpu's.

The port's host-side modules are copies of the JAX package's; these tests
hold them to the same outputs on the same inputs: tokenizer ids and masks,
ShapeBucketer ladders and slices (the cases of tests/test_batching.py plus
a sweep), DataFrame partitioning, Params validation and messages, and
Pipeline save/load.
"""

import numpy as np
import pytest

import synapseml_torch as pt
from synapseml_torch.core import batching as tcb
from synapseml_torch.core.params import GlobalParams, Param, Params, TypeConverters
from synapseml_torch.models.tokenizer import HashingTokenizer, resolve_tokenizer
from synapseml_torch.parallel import pad_sequences
from synapseml_tpu.core import DataFrame as JDataFrame
from synapseml_tpu.core import batching as jcb
from synapseml_tpu.models.tokenizer import HashingTokenizer as JHashingTokenizer
from synapseml_tpu.parallel.batching import pad_sequences as jpad_sequences

TEXTS = ["Hello, world!", "", "A much longer sentence with MANY words, punctuation; "
         "and digits 12345 in it.", "ünïcödé text ok?", "x " * 40]


@pytest.mark.parametrize("vocab,max_len,add_cls", [(30522, 128, True), (64, 8, True),
                                                   (1000, 16, False)])
def test_tokenizer_matches_jax(vocab, max_len, add_cls):
    ours = HashingTokenizer(vocab_size=vocab, add_cls=add_cls)
    ref = JHashingTokenizer(vocab_size=vocab, add_cls=add_cls)
    got, want = ours(TEXTS, max_len=max_len), ref(TEXTS, max_len=max_len)
    for key in ("input_ids", "attention_mask"):
        np.testing.assert_array_equal(got[key], want[key])
        assert got[key].dtype == want[key].dtype
    assert ours.to_config() == ref.to_config()


def test_resolve_tokenizer():
    tok = HashingTokenizer(vocab_size=99)
    assert resolve_tokenizer(tok) is tok
    assert resolve_tokenizer(None).vocab_size == 30522
    assert resolve_tokenizer(tok.to_config()).vocab_size == 99
    with pytest.raises(ValueError, match="only the hashing tokenizer"):
        resolve_tokenizer({"kind": "huggingface", "name": "bert-base-uncased"})
    with pytest.raises(TypeError):
        resolve_tokenizer(3)


def test_pad_sequences_matches_jax():
    seqs = [[1, 2, 3], [], list(range(30)), [7] * 9]
    for kw in ({}, {"max_len": 12}, {"max_len": 12, "multiple_of": 1}, {"pad_value": 5}):
        for a, b in zip(pad_sequences(seqs, **kw), jpad_sequences(seqs, **kw)):
            np.testing.assert_array_equal(a, b)


def test_bucketer_cases_of_the_reference_tests():
    b = tcb.ShapeBucketer(min_bucket=8, max_bucket=64)
    assert b.ladder == (8, 16, 32, 64)
    assert [b.bucket_for(n) for n in (1, 8, 9, 64, 1000)] == [8, 8, 16, 64, 1000]
    assert [b.cap_for(n) for n in (64, 48, 5, 200)] == [64, 32, 5, 200]
    assert list(b.slices(500, 200)) == [(0, 200, 200), (200, 400, 200), (400, 500, 100)]
    assert b.buckets_upto(64) == [8, 16, 32, 64] and b.buckets_upto(48) == [8, 16, 32]
    assert list(b.slices(0, 64)) == []
    s = tcb.ShapeBucketer(min_bucket=8, max_bucket=64, min_seq_bucket=16, max_seq_bucket=128)
    assert s.seq_ladder == (16, 32, 64, 128)
    assert s.seq_bucket_for(17, multiple_of=24) == 48 and s.seq_bucket_for(100, cap=120) == 120
    assert s.seq_buckets_upto(100) == [16, 32, 64, 100]
    with pytest.raises(ValueError):
        s.seq_bucket_for(130, cap=128)
    assert tcb.ShapeBucketer(ladder=[4, 2, 2]).ladder == (2, 4)
    for bad in (dict(ladder=[0, 2]), dict(min_bucket=16, max_bucket=8), dict(seq_ladder=[0, 8])):
        with pytest.raises(ValueError):
            tcb.ShapeBucketer(**bad)


@pytest.mark.parametrize("kw", [{}, dict(min_bucket=8, max_bucket=64), dict(ladder=[3, 10, 24]),
                                dict(min_seq_bucket=8, max_seq_bucket=512)])
def test_bucketer_sweep_matches_jax(kw):
    ours, ref = tcb.ShapeBucketer(**kw), jcb.ShapeBucketer(**kw)
    assert ours.ladder == ref.ladder and ours.seq_ladder == ref.seq_ladder
    for n in (0, 1, 3, 7, 8, 9, 31, 33, 64, 65, 130, 500, 2000):
        for cap in (1, 5, 8, 32, 48, 64, 100, 1024, 3000):
            for mult in (1, 2, 6):
                assert list(ours.slices(n, cap, mult)) == list(ref.slices(n, cap, mult))
                assert ours.cap_for(cap, mult) == ref.cap_for(cap, mult)
                assert ours.buckets_upto(cap, mult) == ref.buckets_upto(cap, mult)
            assert ours.bucket_for(n) == ref.bucket_for(n)
            assert ours.seq_bucket_for(n) == ref.seq_bucket_for(n)
    assert tcb.default_bucketer().ladder == jcb.ShapeBucketer().ladder


def test_pad_rows_modes_match_jax():
    a = np.arange(6, dtype=np.float32).reshape(3, 2)
    for kw in ({}, {"mode": "edge"}, {"mode": "constant", "constant": 1}):
        np.testing.assert_array_equal(tcb.pad_rows(a, 5, **kw), jcb.pad_rows(a, 5, **kw))
    assert tcb.pad_rows(a, 3) is a
    assert tcb.unpad_rows(tcb.pad_rows(a, 5), 3).shape == (3, 2)
    with pytest.raises(TypeError, match="object-dtype"):
        tcb.pad_rows(np.array([[1], "x"], dtype=object), 4)


def test_dataframe_partitioning_matches_jax():
    data = {"x": np.arange(11), "t": [f"r{i}" for i in range(11)]}
    ours, ref = pt.DataFrame.from_dict(data, 3), JDataFrame.from_dict(data, 3)
    assert [len(p["x"]) for p in ours.partitions] == [len(p["x"]) for p in ref.partitions]
    f = lambda p: {**p, "y": p["x"] * 2}  # noqa: E731
    np.testing.assert_array_equal(ours.map_partitions(f).collect_column("y"),
                                  ref.map_partitions(f).collect_column("y"))
    assert list(ours.collect_column("t")) == list(ref.collect_column("t"))
    with pytest.raises(ValueError, match="union schema mismatch"):
        ours.union(ours.select("x"))


class _Scaler(pt.Transformer):
    factor = Param("factor", "multiplier", default=2.0, converter=TypeConverters.to_float,
                   validator=lambda v: v > 0)
    weights = pt.core.ComplexParam("weights", "per-column offsets", default=None)

    def _transform(self, df):
        self.require_columns(df, "x")
        w = self.get("weights")
        return df.with_column("y", lambda p: p["x"] * self.get("factor") + w["b"])


def test_params_validation_and_messages():
    s = _Scaler(factor="3")
    assert s.get("factor") == 3.0 and s.get_factor() == 3.0
    s.set_factor(4)
    assert s.get("factor") == 4.0
    with pytest.raises(ValueError, match="invalid value for param factor"):
        s.set(factor=-1)
    with pytest.raises(KeyError, match="has no param 'fator'; available"):
        s.set(fator=1)
    with pytest.raises(KeyError, match="has no param"):
        s.get("nope")
    assert s.get("nope", None) is None
    with pytest.raises(AttributeError):
        s.get_nope()
    assert "factor: multiplier" in s.explain_params()
    assert set(s.simple_param_values()) == {"factor"} and s.complex_param_values() == {}
    try:
        GlobalParams.set_default(_Scaler, "factor", 7.0)
        assert _Scaler().get("factor") == 7.0
    finally:
        GlobalParams.reset()
    assert Params().uid.startswith("Params_")


def test_pipeline_save_load(tmp_path):
    df =pt.DataFrame.from_dict({"x": np.arange(6, dtype=np.float32)}, 2)
    model = pt.Pipeline(stages=[_Scaler(factor=3, weights={"b": np.float32(0.5)})]).fit(df)
    assert isinstance(model, pt.PipelineModel)
    want = model.transform(df).collect_column("y")
    model.save(str(tmp_path / "p"))
    loaded = pt.PipelineModel.load(str(tmp_path / "p"))
    stage = loaded.get("stages")[0]
    assert stage.uid == model.get("stages")[0].uid and stage.get("factor") == 3.0
    np.testing.assert_array_equal(loaded.transform(df).collect_column("y"), want)
    with pytest.raises(TypeError, match="expected Model"):
        pt.Model.load(str(tmp_path / "p" / "stage_000"))  # a Transformer, not a Model
    with pytest.raises(ValueError, match="not found"):
        model.transform(pt.DataFrame.from_dict({"z": np.arange(2)}))
