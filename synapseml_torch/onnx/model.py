"""ONNXModel — batch inference of an ONNX model on the card.

Counterpart of ``synapseml_tpu/onnx/model.py`` (``ONNXModel`` ``:72-233``,
``slice_model_at_outputs`` ``:31``), with the same Params and defaults and
one more, ``device`` (default ``"cuda"``; a host without a CUDA device must
ask for ``"cpu"``):

  * model bytes -> :class:`~.convert.ConvertedModel` once per stage, its
    float weights moved to the device once;
  * each partition in ``ShapeBucketer.slices`` chunks of at most
    ``mini_batch_size`` rows, the last one edge-padded to its ladder rung,
    so every request size maps onto a few batch shapes;
  * one callable per (rung, feeds, fetches, softmax, argmax) key, got from
    the process-wide ``CompiledCache`` (``fn_id`` ``"onnx_model"``, keyed
    by the stage's ``instance_token``), running the graph and the
    ``softmax_dict`` / ``argmax_dict`` post-columns. It runs eagerly; the
    cache is the door through which a captured CUDA graph of it will come
    (ROADMAP.md queue A item 3);
  * empty partitions get zero-row columns with a non-empty partition's
    dtypes and trailing shapes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import batching as cb
from ..core.dataframe import DataFrame
from ..core.device import device_type, resolve_device
from ..core.params import ComplexParam, Param, TypeConverters
from ..core.pipeline import Transformer
from .convert import ConvertedModel
from .proto import GraphProto, ModelProto, ValueInfoProto, parse_model

__all__ = ["ONNXModel", "slice_model_at_outputs"]


def slice_model_at_outputs(model_bytes: bytes, output_names: list[str]) -> bytes:
    """Cut the graph at (possibly intermediate) values: keep only the nodes
    and initializers reachable backwards from ``output_names``."""
    m = parse_model(model_bytes)
    g = m.graph
    produced_by = {}
    for n in g.node:
        for o in n.output:
            produced_by[o] = n
    needed_values: set[str] = set()
    seen_nodes: set[int] = set()
    stack = list(output_names)
    while stack:
        v = stack.pop()
        if v in needed_values:
            continue
        needed_values.add(v)
        n = produced_by.get(v)
        if n is not None and id(n) not in seen_nodes:
            seen_nodes.add(id(n))
            stack.extend([i for i in n.input if i])
    ordered = [n for n in g.node if id(n) in seen_nodes]
    known = {vi.name: vi for vi in list(g.output) + list(g.value_info) + list(g.input)}
    new_outputs = [known.get(name, ValueInfoProto(name=name)) for name in output_names]
    init_names = {t.name for t in g.initializer}
    new_graph = GraphProto(
        node=ordered,
        name=g.name + "_sliced",
        initializer=[t for t in g.initializer if t.name in needed_values],
        input=[vi for vi in g.input
               if vi.name in needed_values and vi.name not in init_names],
        output=new_outputs,
        value_info=g.value_info,
    )
    return ModelProto(ir_version=m.ir_version, producer_name=m.producer_name,
                      graph=new_graph, opset_import=m.opset_import).encode()


class ONNXModel(Transformer):
    feature_name = "onnx"

    model_payload = ComplexParam("model_payload", "ONNX model protobuf bytes")
    feed_dict = ComplexParam("feed_dict", "model input name -> DataFrame column",
                             default=None)
    fetch_dict = ComplexParam("fetch_dict", "output column -> model output name",
                              default=None)
    mini_batch_size = Param("mini_batch_size", "rows per padded device batch",
                            default=64, converter=TypeConverters.to_int)
    softmax_dict = ComplexParam("softmax_dict", "input col -> softmax output col",
                                default=None)
    argmax_dict = ComplexParam("argmax_dict", "input col -> argmax output col",
                               default=None)
    device = Param("device", "torch device: 'cuda' (default), 'cuda:N' or 'cpu'",
                   default="cuda", converter=TypeConverters.to_string,
                   validator=lambda v: device_type(v) in ("cuda", "cpu"))

    def __init__(self, model_bytes: bytes | None = None, **kw):
        super().__init__(**kw)
        if model_bytes is not None:
            self.set(model_payload=model_bytes)

    # Stage deserialization constructs via cls.__new__, bypassing __init__:
    # the converted model lives behind a lazy accessor, and the callables in
    # the process-wide CompiledCache keyed by this stage's instance_token.

    def set(self, **kw):
        out = super().set(**kw)
        if {"model_payload", "device"} & kw.keys():
            self._drop_runtime()
        return out

    def _drop_runtime(self) -> None:
        """Forget the converted model and evict this stage's callables (a
        dead graph's callables would pin its weights on the device)."""
        self.__dict__.pop("_cache_converted", None)
        cb.invalidate_token(self)

    # -------- model management --------
    def set_model_location(self, path: str) -> "ONNXModel":
        with open(path, "rb") as f:
            return self.set(model_payload=f.read())

    def slice_at_outputs(self, output_names: list[str]) -> "ONNXModel":
        """Re-target the model at intermediate outputs (headless
        featurization)."""
        return self.set(model_payload=slice_model_at_outputs(self.get("model_payload"),
                                                             list(output_names)))

    @property
    def converted(self) -> ConvertedModel:
        if self.__dict__.get("_cache_converted") is None:
            payload = self.get("model_payload")
            if payload is None:
                raise ValueError("ONNXModel: model_payload not set")
            self.__dict__["_cache_converted"] = ConvertedModel(parse_model(payload))
        return self.__dict__["_cache_converted"]

    @property
    def model_input_names(self) -> list[str]:
        return self.converted.input_names

    @property
    def model_output_names(self) -> list[str]:
        return self.converted.output_names

    # -------- transform --------
    def _resolved_feeds(self) -> dict:
        feeds = self.get("feed_dict")
        if feeds:
            return dict(feeds)
        names = self.model_input_names
        if len(names) == 1:
            return {names[0]: "features"}
        raise ValueError(f"feed_dict required for multi-input model {names}")

    def _resolved_fetches(self) -> dict:
        fetches = self.get("fetch_dict")
        if fetches:
            return dict(fetches)
        return {f"out_{n}" if n in ("", None) else n: n
                for n in self.model_output_names}

    def _device(self) -> torch.device:
        return resolve_device("ONNXModel", self.get("device"))

    def _runner(self, feeds: dict, fetches: dict, bucket: int, dtypes: tuple):
        """The callable of one ladder rung: the graph, then the softmax and
        argmax post-columns, from host batches to host columns."""
        soft = dict(self.get("softmax_dict") or {})
        arg = dict(self.get("argmax_dict") or {})

        def build():
            conv, device = self.converted, self._device()
            out_col_of = {v: k for k, v in fetches.items()}
            names = sorted(feeds)

            def fn(*arrays):
                with torch.inference_mode():
                    outs = conv.run(dict(zip(names, arrays)), device)
                    cols = {out_col_of[name]: val for name, val in outs.items()
                            if name in out_col_of}
                    for src, dst in soft.items():
                        cols[dst] = torch.softmax(cols[src], dim=-1)
                    for src, dst in arg.items():
                        cols[dst] = torch.argmax(cols[src], dim=-1).to(torch.int32)
                    return {k: v.cpu().numpy() for k, v in cols.items()}

            return fn

        key = (tuple(sorted(feeds.items())), tuple(sorted(fetches.items())),
               tuple(sorted(soft.items())), tuple(sorted(arg.items())))
        return cb.get_compiled_cache().get(
            "onnx_model", (bucket,) + key, build,
            instance=cb.instance_token(self), dtype=dtypes)

    def _transform(self, df: DataFrame) -> DataFrame:
        feeds = self._resolved_feeds()
        fetches = self._resolved_fetches()
        self.require_columns(df, *feeds.values())
        self._device()
        B = self.get("mini_batch_size")
        bucketer = cb.default_bucketer()

        soft = dict(self.get("softmax_dict") or {})
        arg = dict(self.get("argmax_dict") or {})
        out_cols = list(fetches) + list(soft.values()) + list(arg.values())

        def per_part(p):
            n = len(next(iter(p.values()))) if p else 0
            if n == 0:
                return None  # placeholders filled from a non-empty partition
            cols_in = {name: np.asarray(np.stack(list(p[col])))
                       if p[col].dtype == object else np.asarray(p[col])
                       for name, col in feeds.items()}
            dtypes = tuple(str(cols_in[k].dtype) for k in sorted(feeds))
            results: dict[str, list] = {}
            for start, stop, bucket in bucketer.slices(n, B):
                # edge-repeat padding to the chunk's rung: one callable for
                # every request size that maps to it
                batch = {k: cb.pad_rows(v[start:stop], bucket, mode="edge")
                         for k, v in cols_in.items()}
                runner = self._runner(feeds, fetches, bucket, dtypes)
                out = runner(*[batch[k] for k in sorted(feeds)])
                for col, val in out.items():
                    results.setdefault(col, []).append(cb.unpad_rows(val, stop - start))
            q = dict(p)
            for col in out_cols:
                chunks = results.get(col, [])
                q[col] = np.concatenate(chunks, axis=0) if chunks else np.empty(0)
            return q

        processed = [per_part(p) for p in df.partitions]
        # empty partitions: placeholder columns with the dtype/trailing shape
        # of a non-empty partition's outputs (schema + dtype stability)
        template = next((q for q in processed if q is not None), None)
        out_parts = []
        for p, q in zip(df.partitions, processed):
            if q is not None:
                out_parts.append(q)
                continue
            q = dict(p)
            for col in out_cols:
                if template is not None:
                    ref = template[col]
                    q[col] = np.empty((0,) + ref.shape[1:], dtype=ref.dtype)
                else:
                    q[col] = np.empty(0)
            out_parts.append(q)
        return DataFrame(out_parts)
