"""The paper's own workload configurations (incremental KPCA / Nyström):
the Fig. 1 drift and Fig. 2 Nyström-error runs, with the reference's
fields and values."""
from dataclasses import dataclass


@dataclass(frozen=True)
class KPCAWorkload:
    name: str
    dataset: str          # 'magic' | 'yeast'
    n_seed: int = 20      # paper: matrices of size 20+m
    n_stream: int = 480   # streamed points after the seed
    n_total: int = 1000   # Nyström: first 1000 observations (paper §5.2)
    capacity: int = 512
    adjusted: bool = True
    dtype: str = "float64"   # the paper's NumPy f64; an f32 variant is run


MAGIC = KPCAWorkload(name="paper-magic", dataset="magic")
YEAST = KPCAWorkload(name="paper-yeast", dataset="yeast")

WORKLOADS = {"magic": MAGIC, "yeast": YEAST}
