"""Multi-process data, spatial and pipeline parallelism on
torch.distributed: the port's counterpart of superresolution_tpu/parallel/.
"""

from superresolution_tpu_torch.parallel.mesh import (  # noqa: F401
    batch_sharding,
    create_mesh,
    replicated_sharding,
    shard_batch,
)
from superresolution_tpu_torch.parallel.pipeline import (  # noqa: F401
    make_hat_group_pipeline,
    make_pipeline_forward,
    make_pipeline_loss,
    make_trunk_pipeline,
    pipeline_apply,
    split_scan_params,
)
from superresolution_tpu_torch.parallel.spatial import (  # noqa: F401
    make_spatial_loss,
    spatial_shard_apply,
)
