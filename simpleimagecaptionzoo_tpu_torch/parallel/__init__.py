"""Data parallelism over processes on ``torch.distributed``
(``parallel/mesh.py``), and the mesh's model axis: the prediction head over
a vocab shard (``parallel/vocab_shard.py``)."""
from simpleimagecaptionzoo_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, get_mesh, active_mesh, shard_batch, replicate_tree, place_params,
    local_batch_slice, host_read, host_allgather, barrier, processes_agree,
    configure_collective_timeout, init_process_group, process_count,
    process_index, data_count, all_reduce_sum,
    all_reduce_sum_autograd, global_sum, global_rand, to_device)
