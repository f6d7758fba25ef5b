"""One reader per metric, ``metrics/<name>.py``, each with ``read(run)``
returning the metric's value or None where it finds nothing to read.
``run`` is :class:`port_bench.run.RunView`."""
