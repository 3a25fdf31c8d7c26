"""Optimizers, schedules and gradient compression of the port."""
from repro_torch.optim.compression import (CompressionState, compress_int8,
                                           compressed_psum, decompress_int8)
from repro_torch.optim.optimizers import (OptState, adafactor, adamw,
                                          make_optimizer, sgdm)
from repro_torch.optim.schedules import (constant, cosine, linear_warmup,
                                         make_schedule, wsd)
