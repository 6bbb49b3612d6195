"""IO: model serving and the file helpers of the streaming data plane.

Counterpart of ``synapseml_tpu/io/``: :mod:`.serving` (``ServingServer``,
``serve_pipeline``, ``serve_llm``, the hot swap and the admin and
observability endpoints) and, in :mod:`.files`, the port's copies of the
input-path resolvers, the JSONL line parser and the writers' temp names.
The HTTP-on-DataFrame clients, the eager readers and writers and the Power
BI writer come with ROADMAP.md queue A item 12; ``serve_pipeline_distributed``
(the routing front) with item 10's second half.
"""

from .serving import ServingServer, serve_pipeline

__all__ = ["ServingServer", "serve_pipeline"]
