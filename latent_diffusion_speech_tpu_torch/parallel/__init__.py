"""Data, sequence, tensor, pipeline and expert parallelism on
`torch.distributed`: the process group, the mesh over it, the batch's rows,
the parameters' chunks and the pipeline's stages.

Counterpart of `latent_diffusion_speech_tpu/parallel/`.  The reference's
only parallelism is DDP through HF accelerate; the JAX package lays it out
as a mesh whose `data` axis runs one global program, with XLA inserting the
gradient all-reduce.  Here each process drives one device (`torchrun`
starts one a device), the `data` axis runs over the processes, and the
trainers take the collectives themselves: one coalesced gradient
all-reduce a step (`train/optim.py`), the random draws made for the global
batch with each rank keeping its rows (`mesh.RowGenerator`), and the
losses and statistics that JAX takes over the global batch reduced across
ranks (the LM's token count, the MoE's routing counts, the learned VQ's
EMA statistics).  Tensor and expert parallelism split the parameters by
the JAX package's rules over the mesh's `model` and `expert` axes
(`sharding.py`), each rank running its chunks' partitioned products
(`tensor.py`); such a state is saved one file a rank
(`train/sharded_checkpoint.py`).  Sequence parallelism splits the tokens
over `seq`, self-attention running the ring (`ops/ring_attention.py`);
pipeline parallelism runs the layer stack as GPipe stages over `pipe`
(`pipeline.py`); `dcn_data` stacks slices of processes on `data`.  Each
runs on P2P and collectives between the processes of the axes' groups.
"""

from latent_diffusion_speech_tpu_torch.parallel.dist import (  # noqa: F401
    initialize_distributed,
    is_main_process,
    local_device_count,
    process_count,
    process_index,
    rank_device,
    sync_global_devices,
)
from latent_diffusion_speech_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    MeshSpec,
    RowGenerator,
    build_mesh,
    shard_batch,
)
from latent_diffusion_speech_tpu_torch.parallel.pipeline import (  # noqa: F401
    pipeline_apply,
    stack_stage_params,
)
