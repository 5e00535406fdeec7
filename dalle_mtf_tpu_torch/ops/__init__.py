from dalle_mtf_tpu_torch.ops.pad import pad  # noqa: F401
from dalle_mtf_tpu_torch.ops.xent_fused import chunked_softmax_xent  # noqa: F401
