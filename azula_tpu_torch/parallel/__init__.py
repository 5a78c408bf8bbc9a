r"""Device meshes, data, tensor and sequence parallelism, on `torch.distributed`.

Port of :mod:`azula_tpu.parallel`: meshes over the ranks
(:mod:`~azula_tpu_torch.parallel.mesh`), data-parallel sampling and training
(:mod:`~azula_tpu_torch.parallel.batch`), tensor parallelism and FSDP
(:mod:`~azula_tpu_torch.parallel.tp`), and sequence parallelism by ring and
Ulysses attention (:mod:`~azula_tpu_torch.parallel.ring`,
:mod:`~azula_tpu_torch.parallel.ulysses`), pipeline parallelism
(:mod:`~azula_tpu_torch.parallel.pp`) and the DiT and Flux recipes
(:mod:`~azula_tpu_torch.parallel.recipes`). Each rank is a process on one
card (`nccl`), or on the CPU when the caller asks for `gloo`.
"""

from .mesh import (  # noqa: F401
    axis_group,
    data_sharding,
    gather_batch,
    get_mesh,
    initialize_distributed,
    make_hybrid_mesh,
    make_mesh,
    replicated,
    shard_batch,
)
from .batch import ShardedTrainState, average_gradients, make_train_step_sharded, sample_sharded  # noqa: F401
from .pp import pipeline_blocks, stack_modules  # noqa: F401
from .recipes import flux_serving_shardings, pipeline_dit, serve_flux  # noqa: F401
from .ring import ring_attention, ring_attention_local  # noqa: F401
from .ulysses import ulysses_attention, ulysses_attention_local  # noqa: F401
from .tp import (  # noqa: F401
    DIT_TP_RULES,
    FLUX_TP_RULES,
    SANA_TP_RULES,
    SD_TP_RULES,
    fsdp_shardings,
    module_shardings,
    shard_module,
    shard_module_fsdp,
)
