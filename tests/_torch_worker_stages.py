"""Port stages that worker processes unpickle or load by reference.

A distributed worker (``serve_pipeline_distributed``) is a fresh
interpreter that imports each pickled stage's module from the tests
directory, so these classes live in a module that imports the port and
numpy only, never the JAX package. ``TextsIn``/``ScoresOut`` frame the
text-scoring pipeline of ``_torch_serving_stages.serving_pipelines`` (the
same row functions as that module's adapters, under this module's name);
``EchoPid`` echoes each body with the serving process's pid;
``VersionTag`` answers with its tag (a registry version of the deploy
tests); ``Boom`` raises on every batch with rows. ``BodyToFeatures`` and
``PredToReply`` frame the fleet tests' MLP (``mlp_pipeline``): the port's
twins of ``tests/_aot_pipeline.py``'s stages, around an ``ONNXModel`` of
the same ONNX bytes.
"""

import os

import numpy as np

from synapseml_torch.core.params import Param, TypeConverters
from synapseml_torch.core.pipeline import PipelineModel, Transformer


def texts_of(body):
    if isinstance(body, str) and body:
        return [body]
    if isinstance(body, dict) and isinstance(body.get("texts"), list) and body["texts"]:
        return [str(t) for t in body["texts"]]
    return None


def _explode(p):
    ids, texts, bad = [], [], []
    for rid, body in zip(p["id"], p["body"]):
        got = texts_of(body)
        for t in got or [""]:
            ids.append(rid)
            texts.append(t)
            bad.append(got is None)
    return {"id": np.asarray(ids, dtype=object), "text": np.asarray(texts, dtype=object),
            "bad": np.asarray(bad, dtype=bool)}


def _fold(p):
    groups: dict = {}
    for i, rid in enumerate(p["id"]):
        groups.setdefault(rid, []).append(i)
    replies = []
    for rid, ix in groups.items():
        if p["bad"][ix[0]]:
            replies.append({"error": "body needs 'texts': a non-empty list, or a string"})
        else:
            replies.append({"scores": [[float(x) for x in p["scores"][i]] for i in ix],
                            "prediction": [int(p["prediction"][i]) for i in ix]})
    reply = np.empty(len(replies), dtype=object)
    reply[:] = replies
    return {"id": np.asarray(list(groups), dtype=object), "reply": reply}


class TextsIn(Transformer):
    def _transform(self, df):
        return df.map_partitions(_explode)


class ScoresOut(Transformer):
    def _transform(self, df):
        return df.map_partitions(_fold)


def _echo(p):
    out = dict(p)
    reply = np.empty(len(p["body"]), dtype=object)
    reply[:] = [{"echo": b, "pid": os.getpid()} for b in p["body"]]
    out["reply"] = reply
    return out


class EchoPid(Transformer):
    def _transform(self, df):
        return df.map_partitions(_echo)


class VersionTag(Transformer):
    tag = Param("tag", "version tag echoed in every reply", default="base")

    def _transform(self, df):
        t = self.get("tag")

        def per_part(p):
            out = dict(p)
            reply = np.empty(len(p["body"]), dtype=object)
            reply[:] = [{"v": t, "pid": os.getpid()} for _ in p["body"]]
            out["reply"] = reply
            return out

        return df.map_partitions(per_part)


class Boom(Transformer):
    def _transform(self, df):
        def per_part(p):
            if len(p["id"]):
                raise RuntimeError("this version fails every request")
            return p

        return df.map_partitions(per_part)


class BodyToFeatures(Transformer):
    """Parsed request bodies (``{"features": [...]}``) -> a rectangular
    float32 ``features`` column."""

    din = Param("din", "feature width", default=4, converter=TypeConverters.to_int)

    def _transform(self, df):
        d = self.get("din")

        def per_part(p):
            out = dict(p)
            feats = np.zeros((len(p["body"]), d), np.float32)
            for i, body in enumerate(p["body"]):
                if isinstance(body, dict) and "features" in body:
                    feats[i] = np.asarray(body["features"], np.float32)
            out["features"] = feats
            return out

        return df.map_partitions(per_part)


class PredToReply(Transformer):
    """ONNX outputs -> one JSON-able reply dict per request row."""

    def _transform(self, df):
        def per_part(p):
            out = dict(p)
            preds, probs = p["pred"], p["probs"]
            out["reply"] = np.asarray(
                [{"pred": int(preds[i]), "probs": [round(float(x), 6) for x in probs[i]]}
                 for i in range(len(preds))], dtype=object)
            return out

        return df.map_partitions(per_part)


def mlp_pipeline(onnx_bytes: bytes, din: int = 4, device: str = "cpu") -> PipelineModel:
    """The port's twin of ``_aot_pipeline.build_pipeline`` over the same
    ONNX bytes (``make_mlp_onnx(...).get("model_payload")``)."""
    from synapseml_torch.onnx import ONNXModel

    model = ONNXModel(onnx_bytes, feed_dict={"x": "features"}, fetch_dict={"probs": "probs"},
                      argmax_dict={"probs": "pred"}, mini_batch_size=64, device=device)
    return PipelineModel(stages=[BodyToFeatures(din=din), model, PredToReply()])
