"""File helpers of the streaming data plane.

Counterpart of the part of ``synapseml_tpu/io/`` that ``data/source.py``
leans on: :mod:`.files` keeps the port's own copy of the input-path
resolvers and the JSONL line parser. The eager readers and writers, HTTP
and Power BI clients come with ROADMAP.md queue A item 12.
"""
