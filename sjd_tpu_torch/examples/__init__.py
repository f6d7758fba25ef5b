"""The user-facing command lines of examples/, one module each, named after
the JAX script it ports: ``python -m sjd_tpu_torch.examples.<name>``.

Each takes its JAX script's flags and defaults plus ``--device`` (default
``cuda``; ``--device cpu`` asks for the CPU, and nothing falls back to it)
and prints the script's lines. None imports JAX, PIL or ``transformers``
when imported: images are written and read by ``utils/image_io.py``."""
