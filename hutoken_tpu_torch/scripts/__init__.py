"""The port's drivers, counterparts of the JAX repo's ``scripts/``: each
module runs as ``python -m hutoken_tpu_torch.scripts.<name>``, on the
card unless it is given ``--device cpu`` (``profile_gather`` runs on
the card only).  ``common`` holds what they share, the device-side
timer ``cuda_time`` among it."""
