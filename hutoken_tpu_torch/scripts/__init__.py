"""The port's drivers, counterparts of the JAX repo's ``scripts/``: each
module runs as ``python -m hutoken_tpu_torch.scripts.<name>``, on the
card unless it is given ``--device cpu``."""
