"""Dataset export backends (port of ``d3d_tpu.io``; reference d3d/io): HDF5, LMDB, ROS bag.
Heavy dependencies are imported lazily per backend."""

from . import hdf5  # h5py is baked into the image

__all__ = ["hdf5"]
