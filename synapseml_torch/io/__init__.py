"""IO: model serving and the file helpers of the streaming data plane.

Counterpart of ``synapseml_tpu/io/``: :mod:`.serving` (``ServingServer``,
``serve_pipeline``, ``serve_llm``, the hot swap and the admin and
observability endpoints), :mod:`.distributed_serving` (the routing front
over worker processes, journaled LLM streams, ``RoutingClient`` and
``serve_pipeline_distributed``) and, in :mod:`.files`, the port's copies of
the input-path resolvers, the JSONL line parser and the streamed atomic
JSONL and ``.npy`` writers that the scoring sinks write through.
The HTTP-on-DataFrame clients, the eager readers and writers and the Power
BI writer come with ROADMAP.md queue A item 12.
"""

from .serving import ServingServer, serve_pipeline
from .distributed_serving import serve_pipeline_distributed

__all__ = ["ServingServer", "serve_pipeline", "serve_pipeline_distributed"]
