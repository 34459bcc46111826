"""The paper's own configuration: the ScalLoPS LSH pipeline parameters
(§5.2's best-quality point and §5.3's performance point), plus the dataset
shape grid mirroring Tables 5.1/5.2. A copy of ``repro/configs/scallops.py``
over the port's :class:`~repro_torch.core.pipeline.LSHConfig`."""
from ..core.pipeline import LSHConfig


def quality_config() -> LSHConfig:
    """k=4, T=22, d=0 — the paper's best-quality operating point (§5.2)."""
    return LSHConfig(k=4, T=22, f=32, d=0, scheme="java",
                     join_method="flip")


def perf_config() -> LSHConfig:
    """k=3, T=13, d=0 — the paper's performance-comparison point (§5.3)."""
    return LSHConfig(k=3, T=13, f=32, d=0, scheme="java",
                     join_method="flip")


def optimized_config() -> LSHConfig:
    """Beyond-paper: 64-bit splitmix signatures + banding join + table
    siggen."""
    return LSHConfig(k=3, T=13, f=64, d=3, scheme="splitmix",
                     siggen_method="table", join_method="band")


# Dataset-scale grid from the paper (Tables 5.1/5.2), used to size runs.
DATASETS = {
    "NC_000913": dict(n=4_146, avg_len=316),
    "227_01_prot": dict(n=547_169, avg_len=81),
    "allgos": dict(n=120_723_333, avg_len=24),
    "myva": dict(n=192_987, avg_len=305),
    "swissprot": dict(n=454_401, avg_len=373),
    "nr": dict(n=23_074_873, avg_len=343),
}
