"""Multi-device encode and training on a 1-D data mesh (the port of
``hutoken_tpu/parallel``): ``data_mesh``, ``shard_batch``,
``sharded_merge_words`` (the fixed point with the word axis split over
the shards) and, in ``train``, the device trainers that
``bbpe_train(..., mesh=data_mesh())`` and ``bpe_train(...,
mesh=data_mesh())`` run.  ``multihost`` joins several processes
(``initialize_distributed``) into one mesh (``global_data_mesh``), over
which the trainers run; encode stays process-local, as the JAX engine
cannot place a block on another process's devices either.  Left out:
the host merge of a spelling with more than ``train.MAXC``
compositions across processes, which raises as in the reference."""

from .mesh import DataMesh, data_mesh, shard_batch  # noqa: F401
from .sharded import sharded_merge_words  # noqa: F401
