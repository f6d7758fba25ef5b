"""The plain reference: float32 PyTorch, no kernel, no cache, no batching.

It imports nothing of the port (``sjd_tpu_torch``) and nothing of JAX. It
draws the configuration's weights again from their seed
(:mod:`port_bench.weights`) and works out what the port derives from them
(the int4 and int8 leaves, the int8 KV rows) with its own frozen copy of
that arithmetic (:mod:`.quant`)."""
