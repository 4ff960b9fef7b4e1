"""LMDB dataset dump (port of ``d3d_tpu.io.lmdb``; reference d3d/io/lmdb.py
is an empty stub; this is a working implementation gated on the optional
``lmdb`` package)."""


__all__ = ["dump_dataset"]


def dump_dataset(dataset, out_path, frame_integrity=False, map_size=1 << 40):
    """Dump per-frame lidar data into an LMDB environment keyed
    ``s<idx>/<lidar_name>`` (raw float32 bytes).

    :param frame_integrity: verify each write by reading it back
    """
    try:
        import lmdb
    except ImportError as e:
        raise ImportError("lmdb is required for this module!") from e

    env = lmdb.open(str(out_path), map_size=map_size)
    try:
        with env.begin(write=True) as txn:
            for i in range(len(dataset)):
                # bypass: windowed loaders would return nested per-window
                # lists here
                clouds = dataset.lidar_data(i, dataset.VALID_LIDAR_NAMES,
                                            bypass=True)
                for cloud, name in zip(clouds, dataset.VALID_LIDAR_NAMES):
                    key = f"s{i}/{name}".encode()
                    txn.put(key, cloud.tobytes())
        if frame_integrity:
            # verify AFTER the write transaction commits (reading inside
            # the same txn only sees the buffered write)
            with env.begin() as txn:
                for i in range(len(dataset)):
                    clouds = dataset.lidar_data(
                        i, dataset.VALID_LIDAR_NAMES, bypass=True)
                    for cloud, name in zip(clouds,
                                           dataset.VALID_LIDAR_NAMES):
                        key = f"s{i}/{name}".encode()
                        assert txn.get(key) == cloud.tobytes(), key
    finally:
        env.close()
