"""Dump datasets into HDF5 (port of ``d3d_tpu.io.hdf5``; reference
d3d/io/hdf5.py; the sequence variant
is implemented here rather than stubbed)."""

from pathlib import Path

try:
    import h5py
except ImportError as e:
    raise ImportError("h5py is required for this module!") from e

import tqdm

__all__ = ["dump_dataset", "dump_sequence_dataset"]


def dump_dataset(dataset, out_path, indices=None, size_limit=None,
                 root_name="dataset"):
    """Dump per-frame lidar data of a dataset into HDF5 groups.

    :param indices: optional frame subset (int, list or slice)
    :param size_limit: stop once the output file exceeds this many bytes
    """
    if indices is None:
        indices = range(len(dataset))
    elif isinstance(indices, int):
        indices = [indices]
    elif isinstance(indices, slice):
        indices = range(*indices.indices(len(dataset)))

    out_path = Path(out_path)
    with h5py.File(out_path, "w") as f:
        root = f.create_group(root_name)
        for i in tqdm.tqdm(indices, desc="Dumping"):
            grp = root.create_group("s%d" % i).create_group("lidar_data")
            clouds = dataset.lidar_data(i, dataset.VALID_LIDAR_NAMES)
            for cloud, name in zip(clouds, dataset.VALID_LIDAR_NAMES):
                grp.create_dataset(name, data=cloud, compression="gzip")
            if size_limit and out_path.stat().st_size > size_limit:
                break


def dump_sequence_dataset(dataset, out_path, sequences=None, size_limit=None,
                          root_name="dataset"):
    """Dump lidar data of a sequence dataset, one HDF5 group per sequence
    with per-frame datasets."""
    sequences = dataset.sequence_ids if sequences is None else sequences
    if not isinstance(sequences, (list, tuple)):
        sequences = [sequences]

    out_path = Path(out_path)
    with h5py.File(out_path, "w") as f:
        root = f.create_group(root_name)
        for seq in tqdm.tqdm(sequences, desc="Dumping"):
            seq_group = root.create_group(str(seq))
            nframes = dataset.sequence_sizes[seq]
            for fi in range(nframes):
                clouds = dataset.lidar_data((seq, fi),
                                            dataset.VALID_LIDAR_NAMES,
                                            bypass=True)
                grp = seq_group.create_group("f%d" % fi)
                for cloud, name in zip(clouds, dataset.VALID_LIDAR_NAMES):
                    grp.create_dataset(name, data=cloud, compression="gzip")
                if size_limit and out_path.stat().st_size > size_limit:
                    return
