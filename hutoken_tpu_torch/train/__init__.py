"""BPE vocabulary training (host-exact path).

The port's own copy of ``hutoken_tpu/train/__init__.py``, so that the
port imports nothing of the JAX package; ``tests/test_torch_host.py``
holds the two equal.
"""
