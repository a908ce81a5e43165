from sparkrdma_tpu_torch.runtime.pool import BufferPool, PoolBuffer, RegisteredBuffer  # noqa: F401
from sparkrdma_tpu_torch.runtime.staging import SpillFile  # noqa: F401
