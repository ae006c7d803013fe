from diffsensei_tpu_torch.core.buckets import SIZE_BUCKETS, get_bucket_size, snap_to_bucket
from diffsensei_tpu_torch.core.config import (
    MangaConfig,
    PipelineConfig,
    ResamplerConfig,
    TextEncoderConfig,
    UNetConfig,
    VAEConfig,
    VisionEncoderConfig,
    load_yaml_config,
)
