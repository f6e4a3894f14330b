"""Catalog of the real benchmark datasets: the on-disk layout under a
data root, so that the command line picks a dataset up when
``PIT_REAL_DATA_DIR`` is set or ``--data-path`` names the root.

The layout (names as the reference training scripts load them):

    $PIT_REAL_DATA_DIR/
        data_burgers.mat                      (keys x, y)
        data_sod.mat                          (keys x, y; conservative vars)
        darcy/piececonst_r421_N1024_smooth1.mat   (keys coeff, sol)
        darcy/piececonst_r421_N1024_smooth2.mat
        vorticity/NavierStokes_V1e-4_N1200_T30.mat  (key u)
        elasticity/Random_UnitCell_rr_10.npy
        elasticity/Random_UnitCell_XY_10.npy
        elasticity/Random_UnitCell_sigma_10.npy
        naca/shape_coords.npy
        naca/NACA_Cylinder_X.npy
        naca/NACA_Cylinder_Y.npy
        naca/NACA_Cylinder_Q.npy
        cylinder/WakeCylinder_train.mat       (key trajectories)
        cylinder/WakeCylinder_test.mat
        cylinder/vertices.csv
        cylinder/vertices_small.csv
        cylinder/elements.csv

Nothing here downloads.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional


@dataclasses.dataclass(frozen=True)
class Dataset:
    """One benchmark family's real-data requirements."""

    benchmark: str  # canonical benchmark name (tf variants share it)
    files: tuple  # paths relative to the data root
    source: str  # where to get it (reference: README.md:17-24)
    # the ``data_path`` of the benchmark's setup, given the data root (a
    # file for burgers, sod and vorticity, a directory for the rest)
    data_path: Callable


DATASETS = {
    "burgers": Dataset(
        "burgers",
        ("data_burgers.mat",),
        "Lanthaler et al., https://zenodo.org/records/7118642 "
        "(reference: README.md:18-19)",
        lambda root: os.path.join(root, "data_burgers.mat"),
    ),
    "sod": Dataset(
        "sod",
        ("data_sod.mat",),
        "Lanthaler et al., https://zenodo.org/records/7118642",
        lambda root: os.path.join(root, "data_sod.mat"),
    ),
    "darcy": Dataset(
        "darcy",
        (
            "darcy/piececonst_r421_N1024_smooth1.mat",
            "darcy/piececonst_r421_N1024_smooth2.mat",
        ),
        "FNO datasets (Li et al.), Google Drive folder "
        "1UnbQh2WWc6knEHbLn-ZaXrKUZhp7pjt- (reference: README.md:20-21)",
        lambda root: os.path.join(root, "darcy"),
    ),
    "vorticity": Dataset(
        "vorticity",
        ("vorticity/NavierStokes_V1e-4_N1200_T30.mat",),
        "FNO datasets (Li et al.), Google Drive folder "
        "1UnbQh2WWc6knEHbLn-ZaXrKUZhp7pjt-",
        lambda root: os.path.join(
            root, "vorticity", "NavierStokes_V1e-4_N1200_T30.mat"
        ),
    ),
    "elasticity": Dataset(
        "elasticity",
        (
            "elasticity/Random_UnitCell_rr_10.npy",
            "elasticity/Random_UnitCell_XY_10.npy",
            "elasticity/Random_UnitCell_sigma_10.npy",
        ),
        "Geo-FNO datasets (Li et al.), Google Drive folder "
        "1YBuaoTdOSr_qzaow-G-iwvbUI7fiUzu8 (reference: README.md:22)",
        lambda root: os.path.join(root, "elasticity"),
    ),
    "naca": Dataset(
        "naca",
        (
            "naca/shape_coords.npy",
            "naca/NACA_Cylinder_X.npy",
            "naca/NACA_Cylinder_Y.npy",
            "naca/NACA_Cylinder_Q.npy",
        ),
        "Geo-FNO datasets (Li et al.), Google Drive folder "
        "1YBuaoTdOSr_qzaow-G-iwvbUI7fiUzu8",
        lambda root: os.path.join(root, "naca"),
    ),
    "cylinder": Dataset(
        "cylinder",
        (
            "cylinder/WakeCylinder_train.mat",
            "cylinder/WakeCylinder_test.mat",
            "cylinder/vertices.csv",
            "cylinder/vertices_small.csv",
            "cylinder/elements.csv",
        ),
        "FEniCS-generated, Google Drive folder "
        "1efL-RR_H43Pe6P5BLtcEPFgz7ZmXnl5a (reference: README.md:24)",
        lambda root: os.path.join(root, "cylinder"),
    ),
}

# tf-family benchmarks load the same raw files
_ALIASES = {f"{k}_tf": k for k in DATASETS}


def dataset_for(benchmark: str) -> Optional[Dataset]:
    """The :class:`Dataset` a benchmark name needs (a TF-family name reads
    its torch-family sibling's files), or None (a registered benchmark has
    no cataloged data)."""
    return DATASETS.get(_ALIASES.get(benchmark, benchmark))


def available(benchmark: str, root: str) -> bool:
    """True when every file the benchmark needs exists under ``root`` and
    is a real file (not a git-LFS stub)."""
    from position_induced_transformer_torch.data.loaders import _is_real_file

    ds = dataset_for(benchmark)
    return ds is not None and all(
        _is_real_file(os.path.join(root, f)) for f in ds.files
    )


def data_path_for(benchmark: str, root: str) -> Optional[str]:
    """The ``data_path`` to hand the benchmark's setup function for the
    layout under ``root``, or None when a file is missing (callers then
    stay on synthetic data)."""
    if not available(benchmark, root):
        return None
    return dataset_for(benchmark).data_path(root)


def real_data_root() -> Optional[str]:
    """The user-configured real-data root (``PIT_REAL_DATA_DIR``), if set."""
    root = os.environ.get("PIT_REAL_DATA_DIR")
    return root or None
