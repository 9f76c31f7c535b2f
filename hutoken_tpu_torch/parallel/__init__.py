"""Multi-device training on a 1-D data mesh (the port of
``hutoken_tpu/parallel``): ``data_mesh``, ``shard_batch`` and, in
``train``, the device trainers that ``bbpe_train(..., mesh=data_mesh())``
and ``bpe_train(..., mesh=data_mesh())`` run.  Sharded encode and
multi-host are not ported yet."""

from .mesh import DataMesh, data_mesh, shard_batch  # noqa: F401
