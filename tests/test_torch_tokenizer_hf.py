"""synapseml_torch's transformers tokenizer adapter against the JAX package's.

A ``BertTokenizer`` is built from a ``vocab.txt`` the test writes and saved
into a directory (beside a seeded Llama checkpoint for the stage case); no
download. Both packages' ``resolve_tokenizer(dir)`` give identical ids,
masks, vocab sizes, configs and decoded text; ``tokenizer_for_checkpoint``
finds a directory's tokenizer; ``HuggingFaceCausalLM`` decodes text as the
JAX stage does. Without ``transformers`` a checkpoint's tokenizer ends in
the JAX package's "pass tokenizer=" ``ValueError``, never an
``ImportError``; so does a directory without tokenizer files, before
``transformers`` is asked.
"""

import sys

import numpy as np
import pytest
import torch

# imported at collection, before an ONNX test can leave its spec-less onnx
# stand-in in sys.modules (ROADMAP.md queue C)
transformers = pytest.importorskip("transformers")

from _hf_checkpoints import llama_dir  # noqa: E402

import synapseml_torch as pt  # noqa: E402
from synapseml_torch.hf import HuggingFaceCausalLM  # noqa: E402
from synapseml_torch.models import convert_hf as T  # noqa: E402
from synapseml_torch.models import tokenizer as ttok  # noqa: E402
from synapseml_tpu.core import DataFrame as JDataFrame  # noqa: E402
from synapseml_tpu.hf import HuggingFaceCausalLM as JHuggingFaceCausalLM  # noqa: E402
from synapseml_tpu.models import convert_hf as J  # noqa: E402
from synapseml_tpu.models import tokenizer as jtok  # noqa: E402

_VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + (
    "the a of and to in is was for on that with as it this be are quick brown fox jumps "
    "over lazy dog hello world paged engines free their pages good bad film plot "
    "##s ##ing ##ed ##er , . !").split()
TEXTS = ["Hello world!", "the quick brown fox jumps over the lazy dog", "",
         "paged engines free their pages, and jumping foxes", "unknownword the films"]


def _tokenizer_dir(d):
    from transformers import BertTokenizer

    d.mkdir(parents=True, exist_ok=True)
    vocab = d / "vocab.txt"
    vocab.write_text("\n".join(_VOCAB) + "\n")
    BertTokenizer(vocab_file=str(vocab)).save_pretrained(str(d))
    return str(d)


@pytest.fixture(scope="module")
def tok_dir(tmp_path_factory):
    return _tokenizer_dir(tmp_path_factory.mktemp("tok"))


@pytest.mark.parametrize("max_len,multiple_of", [(16, 8), (7, 1), (5, 4)])
def test_resolve_tokenizer_of_a_directory_matches_jax(tok_dir, max_len, multiple_of):
    got, want = ttok.resolve_tokenizer(tok_dir), jtok.resolve_tokenizer(tok_dir)
    assert got.vocab_size == want.vocab_size == len(_VOCAB)
    assert got.to_config() == want.to_config() == {"kind": "huggingface", "name": tok_dir}
    g, w = got(TEXTS, max_len=max_len, multiple_of=multiple_of), \
        want(TEXTS, max_len=max_len, multiple_of=multiple_of)
    for key in ("input_ids", "attention_mask"):
        assert g[key].dtype == w[key].dtype == np.int32
        np.testing.assert_array_equal(g[key], w[key])
    for row in g["input_ids"]:
        assert got.decode(row) == want.decode(row)
    again = ttok.resolve_tokenizer(got.to_config())  # a saved model's tokenizer_config
    np.testing.assert_array_equal(again(TEXTS, max_len=max_len)["input_ids"],
                                  got(TEXTS, max_len=max_len)["input_ids"])
    assert ttok.resolve_tokenizer(got) is got


def test_tokenizer_for_checkpoint_finds_the_directory_tokenizer(tmp_path):
    d, _ = llama_dir(tmp_path / "ckpt", vocab=len(_VOCAB) + 3, layers=1)
    _tokenizer_dir(tmp_path / "ckpt")
    got = T.tokenizer_for_checkpoint(None, d, len(_VOCAB) + 3)
    want = J.tokenizer_for_checkpoint(None, d, len(_VOCAB) + 3)
    assert got.to_config() == want.to_config()
    np.testing.assert_array_equal(got(TEXTS)["input_ids"], want(TEXTS)["input_ids"])
    # the vocab guard: a table smaller than the tokenizer
    with pytest.raises(ValueError, match="exceeds the checkpoint") as err:
        T.tokenizer_for_checkpoint(None, d, len(_VOCAB) - 1)
    with pytest.raises(ValueError, match="exceeds the checkpoint") as jerr:
        J.tokenizer_for_checkpoint(None, d, len(_VOCAB) - 1)
    assert str(err.value) == str(jerr.value)


def test_a_directory_without_tokenizer_files_asks_for_a_tokenizer(tmp_path, monkeypatch):
    """No tokenizer file in the directory: refused before transformers is
    asked (transformers 5 would build an empty-vocabulary tokenizer from
    config.json alone); the JAX package, asking transformers 4, raises the
    same error here."""
    d, _ = llama_dir(tmp_path / "ckpt", layers=1)
    with pytest.raises(ValueError, match="pass tokenizer=") as want:
        J.tokenizer_for_checkpoint(None, d, 89)
    asked = []
    monkeypatch.setattr(ttok, "from_huggingface", lambda name: asked.append(name))
    with pytest.raises(ValueError, match="pass tokenizer=") as got:
        T.tokenizer_for_checkpoint(None, d, 89)
    assert str(got.value) == str(want.value) and not asked


def test_without_transformers_a_checkpoint_asks_for_a_tokenizer(tmp_path, monkeypatch):
    """A host without transformers: a directory's tokenizer (or a name)
    cannot load, and the error is the JAX package's ValueError."""
    d, _ = llama_dir(tmp_path / "ckpt", layers=1)
    _tokenizer_dir(tmp_path / "ckpt")  # its files are there; transformers is not
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ValueError, match="could not load HuggingFace tokenizer"):
        ttok.resolve_tokenizer(d)
    with pytest.raises(ValueError, match="pass tokenizer=") as err:
        T.tokenizer_for_checkpoint(None, d, 89)
    assert isinstance(err.value.__cause__, ValueError)
    assert isinstance(err.value.__cause__.__cause__, ImportError)
    stage = HuggingFaceCausalLM(model_name=d, max_new_tokens=2, prompt_bucket=8, device="cpu")
    with pytest.raises(ValueError, match="pass tokenizer="):
        stage.transform(pt.DataFrame.from_rows([{"prompt": "x"}]))


@pytest.fixture
def f32_causal_lm(monkeypatch):
    import functools

    import jax.numpy as jnp

    from synapseml_torch.hf import causal_lm as tcl

    monkeypatch.setattr(J, "pretrained_causal_lm",
                        functools.partial(J.pretrained_causal_lm, dtype=jnp.float32))
    monkeypatch.setattr(tcl, "pretrained_causal_lm",
                        functools.partial(T.pretrained_causal_lm, dtype=torch.float32))


@pytest.mark.parametrize("engine", ["dense", "paged"])
def test_causal_lm_decodes_text_with_the_directory_tokenizer(tmp_path, f32_causal_lm, engine):
    """model_name=<dir> with the directory's own tokenizer (tokenizer=None):
    completions are decoded text, equal to the JAX stage's."""
    d, _ = llama_dir(tmp_path / "ckpt", vocab=len(_VOCAB), layers=1, seed=4)
    _tokenizer_dir(tmp_path / "ckpt")
    data = {"prompt": np.asarray(TEXTS[:2] + TEXTS[3:], dtype=object)}
    # the adapter pads to max_len - max_new_tokens rounded up to prompt_bucket: 120
    kw = dict(model_name=d, max_new_tokens=8, prompt_bucket=8, batch_size=2, engine=engine)
    want = list(JHuggingFaceCausalLM(**kw).transform(
        JDataFrame.from_dict(data, num_partitions=2)).collect_column("completions"))
    got = list(HuggingFaceCausalLM(**kw, device="cpu").transform(
        pt.DataFrame.from_dict(data, num_partitions=2)).collect_column("completions"))
    assert got == want
    assert all(isinstance(t, str) for t in got)


def test_deep_text_classifier_takes_the_directory_tokenizer(tmp_path):
    """A BERT directory with its own tokenizer and tokenizer=None: the fit
    tokenizes with it and the fitted model keeps it as its config."""
    from _hf_checkpoints import bert_dir

    from synapseml_torch.models import text as ttext

    d, _ = bert_dir(tmp_path / "bert", vocab=len(_VOCAB))
    _tokenizer_dir(tmp_path / "bert")
    rows = [{"text": t, "label": i % 2} for i, t in enumerate(TEXTS * 2)]
    stage = ttext.DeepTextClassifier(checkpoint=d, num_classes=2, batch_size=4,
                                     max_token_len=16, max_steps=2, device="cpu")
    _, data, _, _, tok = stage._fit_plan(pt.DataFrame.from_rows(rows))
    want = jtok.resolve_tokenizer(d)([r["text"] for r in rows], max_len=16)
    np.testing.assert_array_equal(data["input_ids"], want["input_ids"])
    model = stage.fit(pt.DataFrame.from_rows(rows))
    assert model.get("tokenizer_config") == {"kind": "huggingface", "name": d}
    scores = np.stack(list(model.transform(pt.DataFrame.from_rows(rows[:3]))
                           .collect_column("scores")))
    assert scores.shape == (3, 2) and np.all(np.isfinite(scores))
