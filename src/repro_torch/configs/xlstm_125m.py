"""xlstm-125m [ssm] — sLSTM + mLSTM blocks (arXiv:2405.04517), ratio ~5:1
mLSTM:sLSTM.  Blocks carry their own up/down projections (d_ff=0: no
separate FFN).  Recurrent decode state is O(1) in context length, so the
long_500k cell runs for this arch.

12L d_model=768 4H d_ff=0 vocab=50304.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,                      # mLSTM/sLSTM blocks are self-contained
    vocab=50304,
    block_pattern=("mlstm", "mlstm", "mlstm", "mlstm", "mlstm", "slstm"),
    xlstm_expand=2,
    ssm_chunk=256,
    tie_embeddings=True,
    dtype="bfloat16",
)
