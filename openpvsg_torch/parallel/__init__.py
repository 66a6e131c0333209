"""The multi-device half of the port (``openpvsg_tpu/parallel``): a
``(data, time)`` mesh of local devices with replicated modules, frame-
and pair-sharded executors (``sp``), the time-sharded relation head
(``tp``), and the ``torch.distributed`` process-group helpers of the
multi-process trainer and CLIs."""
from openpvsg_torch.parallel.mesh import (Mesh, all_reduce_sum, init_distributed,
                                          make_mesh, rank, replicate, shard_batch,
                                          world)
