from sparkrdma_tpu_torch.shuffle.map_output import (  # noqa: F401
    BlockLocation,
    DriverTable,
    MapTaskOutput,
    ENTRY_SIZE,
    MAP_ENTRY_SIZE,
)
from sparkrdma_tpu_torch.shuffle.location_plane import (  # noqa: F401
    EPOCH_DEAD,
    LocationPlane,
    ShardMap,
    ShardStore,
)
from sparkrdma_tpu_torch.shuffle.planner import (  # noqa: F401
    PlanTask,
    ReducePlan,
    ReducePlanner,
    SizeHistogram,
    identity_plan,
    slice_aligned_partition_map,
)
