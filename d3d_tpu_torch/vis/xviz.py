"""Stream tracking datasets to an Uber AVS / XVIZ frontend (port of
``d3d_tpu.vis.xviz``; reference
d3d/vis/xviz.py + serve_xviz.py). Gated on the optional ``xviz_avs``
package."""

__all__ = ["TrackingDatasetConverter", "serve_dataset"]

PRIMARY_POSE_STREAM = "/vehicle_pose"


def _require_xviz():
    try:
        import xviz_avs  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "xviz_avs is required for XVIZ streaming; install it from "
            "github.com/aurora-opensource/xviz/tree/master/python") from e


class TrackingDatasetConverter:
    """Convert frames of a TrackingDatasetBase into XVIZ messages.

    :param lidar_names: lidar streams to publish (default: all)
    :param camera_names: camera streams to publish (default: none)
    """

    def __init__(self, dataset, sequence, lidar_names=None, camera_names=None):
        _require_xviz()
        self.dataset = dataset
        self.sequence = sequence
        self.lidar_names = lidar_names or dataset.VALID_LIDAR_NAMES
        self.camera_names = camera_names or []

    def get_metadata(self):
        from xviz_avs.builder import XVIZMetadataBuilder

        builder = XVIZMetadataBuilder()
        builder.stream(PRIMARY_POSE_STREAM).category("pose")
        for name in self.lidar_names:
            builder.stream(f"/lidar/{name}") \
                .category("primitive").type("point") \
                .coordinate("VEHICLE_RELATIVE")
        for name in self.camera_names:
            builder.stream(f"/camera/{name}").category("primitive") \
                .type("image")
        builder.stream("/objects").category("primitive").type("polygon") \
            .coordinate("VEHICLE_RELATIVE")
        return builder.get_message()

    def get_message(self, frame_idx):
        import numpy as np
        from xviz_avs.builder import XVIZBuilder

        if not hasattr(self, "_metadata_cache"):  # build once, reuse
            self._metadata_cache = self.get_metadata()
        builder = XVIZBuilder(metadata=self._metadata_cache)
        idx = (self.sequence, frame_idx)
        ts = self.dataset.timestamp(idx, bypass=True) / 1e6
        pose = self.dataset.pose(idx, bypass=True)
        yaw, pitch, roll = pose.orientation.as_euler("ZYX")
        builder.pose(PRIMARY_POSE_STREAM) \
            .timestamp(ts) \
            .position(*pose.position) \
            .orientation(roll, pitch, yaw)

        for name in self.lidar_names:
            cloud = self.dataset.lidar_data(idx, name, bypass=True)
            builder.primitive(f"/lidar/{name}").points(
                np.asarray(cloud[:, :3], dtype=np.float32).ravel())

        objs = self.dataset.annotation_3dobject(idx, bypass=True)
        for obj in objs:
            footprint = obj.corners[[0, 1, 3, 2], :]
            builder.primitive("/objects").polygon(
                footprint.ravel().tolist()).id(str(obj.tid))
        return builder.get_message()


def serve_dataset(dataset, sequence, host="0.0.0.0", port=8081):
    """Run a websocket XVIZ session serving one sequence."""
    _require_xviz()
    import asyncio

    import websockets

    converter = TrackingDatasetConverter(dataset, sequence)
    nframes = dataset.sequence_sizes[sequence]

    async def handler(socket, _path=None):
        meta = converter.get_metadata()
        await socket.send(meta.to_proto().SerializeToString())
        for fi in range(nframes):
            msg = converter.get_message(fi)
            await socket.send(msg.to_proto().SerializeToString())
            await asyncio.sleep(0.1)

    async def _main():
        # asyncio.run pattern: get_event_loop() from sync context is
        # deprecated (3.12) and removed (3.14)
        async with websockets.serve(handler, host, port):
            await asyncio.Future()  # run forever

    asyncio.run(_main())
