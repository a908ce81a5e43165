from sparkrdma_tpu_torch.parallel.rpc_msg import (  # noqa: F401
    AnnounceMsg,
    HelloMsg,
    RpcMsg,
    decode_message,
    segments,
    Reassembler,
)
