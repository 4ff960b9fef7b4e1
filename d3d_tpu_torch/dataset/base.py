"""Dataset loader interfaces, train/val splitting, index/sensor fan-out
decorators and the multiprocessing NumberPool (port of
``d3d_tpu.dataset.base``; framework-agnostic host Python, the device work
happens after loading). ``tqdm`` is imported only where a progress bar is
drawn (:meth:`DetectionDatasetBase.analyze_3dobject`, :class:`NumberPool`),
so importing a loader does not need it.
"""

import functools
import inspect
from collections import defaultdict
from multiprocessing import Manager, Pool
from pathlib import Path
from threading import Event

import numpy as np

__all__ = [
    "split_trainval", "split_trainval_seq", "check_frames",
    "DatasetBase", "MultiModalDatasetMixin", "DetectionDatasetBase",
    "SegmentationDatasetMixin", "SequenceDatasetBase",
    "MultiModalSequenceDatasetMixin", "TrackingDatasetBase",
    "expand_idx", "expand_name", "expand_idx_name", "NumberPool",
]


def split_trainval(phase, total_count, trainval_split, trainval_random):
    """Frame indices of the requested phase.

    :param phase: training | validation | testing
    :param trainval_split: train fraction, or an explicit index list
    :param trainval_random: False = natural order, True = fresh shuffle,
        int = seeded shuffle, "r" = reversed order
    """
    if isinstance(trainval_split, list):
        return trainval_split

    if isinstance(trainval_random, bool):
        frames = (np.random.default_rng().permutation(total_count)
                  if trainval_random else np.arange(total_count))
    elif isinstance(trainval_random, int):
        frames = np.random.default_rng(seed=trainval_random).permutation(
            total_count)
    elif trainval_random == "r":
        frames = np.arange(total_count)[::-1]
    else:
        raise ValueError("Invalid trainval_random type!")

    cut = int(total_count * trainval_split)
    if phase == "training":
        return frames[:cut]
    if phase == "validation":
        return frames[cut:]
    return frames


def split_trainval_seq(phase, seq_counts, trainval_split, trainval_random,
                       by_seq=False):
    """Like :func:`split_trainval` but optionally split whole sequences.

    :param seq_counts: ordered mapping sequence id -> frame count
    """
    if not by_seq:
        return split_trainval(phase, sum(seq_counts.values()),
                              trainval_split, trainval_random)

    starts = {}
    counter = 0
    for sid, cnt in seq_counts.items():
        starts[sid] = counter
        counter += cnt

    if isinstance(trainval_split, list):
        seqs = trainval_split
    else:
        seqs = list(seq_counts.keys())
        cut = int(len(seqs) * trainval_split)
        if phase == "training":
            seqs = seqs[:cut]
        elif phase == "validation":
            seqs = seqs[cut:]
        elif phase != "testing":
            raise ValueError("Incorrect dataset phase!")

    frames = []
    if isinstance(trainval_random, bool) and not trainval_random:
        for seq in seqs:
            frames.append(np.arange(seq_counts[seq]) + starts[seq])
    elif trainval_random == "r":
        for seq in seqs[::-1]:
            frames.append(np.arange(seq_counts[seq])[::-1] + starts[seq])
    else:
        seed = None if isinstance(trainval_random, bool) else trainval_random
        rng = np.random.default_rng(seed=seed)
        for sid in rng.permutation(len(seqs)):
            seq = seqs[sid]
            frames.append(rng.permutation(seq_counts[seq]) + starts[seq])
    return np.concatenate(frames) if frames else np.zeros(0, int)


def check_frames(names, valid):
    """Normalize a sensor-name argument to a list; returns (unpack, names)
    where unpack means a single name was passed and the result should be
    unwrapped."""
    unpack = False
    if names is None:
        names = list(valid)
    elif isinstance(names, str):
        names = [names]
        unpack = True
    for name in names:
        if name not in valid:
            raise ValueError(
                "Invalid frame name %s, valid options are %s"
                % (name, ", ".join(valid)))
    return unpack, names


class DatasetBase:
    """Base of all dataset loaders.

    :param base_path: directory containing the (zipped or unzipped) data
    :param inzip: read from the original zip archives
    :param phase: training | validation | testing
    :param trainval_split: see :func:`split_trainval`
    :param trainval_random: see :func:`split_trainval`
    """

    def __init__(self, base_path, inzip=False, phase="training",
                 trainval_split=1.0, trainval_random=False):
        if phase not in ("training", "validation", "testing"):
            raise ValueError("Invalid phase tag")
        self.base_path = Path(base_path)
        self.inzip = inzip
        self.phase = phase
        self._return_file_path = False

    def __len__(self):
        raise NotImplementedError("abstract function")

    class _ReturnPathContext:
        def __init__(self, ds):
            self.ds = ds

        def __enter__(self):
            if self.ds.inzip:
                raise RuntimeError("Cannot return path from a dataset in zip!")
            self.ds._return_file_path = True

        def __exit__(self, *exc):
            self.ds._return_file_path = False

    def return_path(self):
        """Context manager making accessors return raw file paths."""
        return DatasetBase._ReturnPathContext(self)

    def identity(self, idx):
        """A tuple uniquely identifying the frame within the dataset."""
        raise NotImplementedError("abstract function")


class MultiModalDatasetMixin:
    """Interface for datasets with lidar + camera + calibration."""

    VALID_CAM_NAMES = []
    VALID_LIDAR_NAMES = []

    def lidar_data(self, idx, names=None, formatted=False):
        raise NotImplementedError("abstract function")

    def camera_data(self, idx, names=None):
        raise NotImplementedError("abstract function")

    def calibration_data(self, idx, raw=None):
        raise NotImplementedError("abstract function")


class DetectionDatasetBase(DatasetBase, MultiModalDatasetMixin):
    """Interface for 3D object detection datasets."""

    VALID_OBJ_CLASSES = None

    def annotation_3dobject(self, idx, raw=None):
        """Ground-truth targets (in the lidar frame by convention)."""
        raise NotImplementedError("abstract function")

    def analyze_3dobject(self):
        """Statistics (mean dimensions per class) over the labels."""
        from tqdm import trange

        dims = defaultdict(list)
        for i in trange(len(self), desc="Analyzing"):
            for obj in self.annotation_3dobject(i):
                dims[obj.tag_top].append(obj.dimension)
        return dict(mean_dimension={k: np.mean(v, axis=0)
                                    for k, v in dims.items()})


class SegmentationDatasetMixin:
    """Interface for point-cloud segmentation labels."""

    VALID_PTS_CLASSES = None

    def annotation_3dpoints(self, idx, names=None, formatted=False):
        raise NotImplementedError("abstract function")


class SequenceDatasetBase(DatasetBase):
    """Base for sequence datasets; accessors optionally return windows of
    ``nframes + 1`` consecutive frames (see :func:`expand_idx`)."""

    def __init__(self, base_path, inzip=False, phase="training",
                 trainval_split=1.0, trainval_random=False,
                 trainval_byseq=False, nframes=0):
        super().__init__(base_path, inzip=inzip, phase=phase,
                         trainval_split=trainval_split,
                         trainval_random=trainval_random)
        self.nframes = abs(nframes)

    def _locate_frame(self, idx):
        """Overall index -> (sequence id, starting frame index)."""
        raise NotImplementedError("_locate_frame is not implemented!")

    @property
    def sequence_sizes(self):
        raise NotImplementedError("abstract function")

    @property
    def sequence_ids(self):
        raise NotImplementedError("abstract function")

    def timestamp(self, idx, names=None):
        """Unix timestamp of the frame in microseconds."""
        raise NotImplementedError("abstract function")

    def intermediate_data(self, idx, names=None, ninter_frames=1):
        """Unannotated data between keyframes (empty by default)."""
        return []


class MultiModalSequenceDatasetMixin:
    """Multi-modal accessors over sequences: len(names) x (nframes+1) items."""

    VALID_CAM_NAMES = []
    VALID_LIDAR_NAMES = []

    def lidar_data(self, idx, names=None, formatted=False):
        raise NotImplementedError("abstract function")

    def camera_data(self, idx, names=None):
        raise NotImplementedError("abstract function")

    def calibration_data(self, idx, raw=False):
        raise NotImplementedError("abstract function")


class TrackingDatasetBase(SequenceDatasetBase, MultiModalSequenceDatasetMixin):
    """Sequence dataset with per-frame object annotations carrying unique
    track ids, plus ego poses."""

    def annotation_3dobject(self, idx, raw=False):
        raise NotImplementedError("abstract function")

    def pose(self, idx, raw=False, names=None):
        """Ego pose (ENU ground-attached base frame)."""
        raise NotImplementedError("abstract function")

    @property
    def pose_name(self):
        raise NotImplementedError("abstract property")


# ---------------------------------------------------------------------------
# accessor fan-out decorators
# ---------------------------------------------------------------------------

def expand_idx(func):
    """Wrap a single-frame accessor so that integer indices are resolved via
    ``_locate_frame`` and, when ``self.nframes > 0``, a window of frames is
    returned. ``bypass=True`` calls the raw single-frame function."""

    @functools.wraps(func)
    def wrapper(self, idx, *args, **kwargs):
        bypass = kwargs.pop("bypass", False)
        seq_id, frame_idx = (self._locate_frame(idx)
                             if isinstance(idx, (int, np.integer)) else idx)
        if self.nframes == 0 or bypass:
            return func(self, (seq_id, frame_idx), *args, **kwargs)
        return [func(self, (seq_id, fi), *args, **kwargs)
                for fi in range(frame_idx, frame_idx + self.nframes + 1)]

    return wrapper


def expand_name(valid_names):
    """Decorator factory fanning an accessor out over a list of sensor
    names (single name in -> single result out)."""

    def decorator(func):
        default = inspect.signature(func).parameters["names"].default
        assert default is not inspect.Parameter.empty, \
            "The decorated function should have default names value"

        @functools.wraps(func)
        def wrapper(self, idx, names=default, *args, **kwargs):
            unpack, names = check_frames(names, valid_names)
            results = [func(self, idx, name, *args, **kwargs)
                       for name in names]
            return results[0] if unpack else results

        return wrapper

    return decorator


def expand_idx_name(valid_names):
    """Decorator factory fanning out over both frame windows and sensor
    names (see :func:`expand_idx` / :func:`expand_name`)."""

    def decorator(func):
        default = inspect.signature(func).parameters["names"].default
        assert default is not inspect.Parameter.empty, \
            "The decorated function should have default names value"

        @functools.wraps(func)
        def wrapper(self, idx, names=default, *args, **kwargs):
            bypass = kwargs.pop("bypass", False)
            seq_id, frame_idx = (self._locate_frame(idx)
                                 if isinstance(idx, (int, np.integer)) else idx)
            unpack, names = check_frames(names, valid_names)

            results = []
            for name in names:
                # pass the name POSITIONALLY: `names=name, *args` makes any
                # caller-positional argument collide with the names keyword
                if self.nframes == 0 or bypass:
                    results.append(
                        func(self, (seq_id, frame_idx), name,
                             *args, **kwargs))
                else:
                    results.append(
                        [func(self, (seq_id, fi), name, *args, **kwargs)
                         for fi in range(frame_idx,
                                         frame_idx + self.nframes + 1)])
            return results[0] if unpack else results

        return wrapper

    return decorator


def locate_windowed_frame(idx, frame_counts, nframes):
    """Map a flat dataset index onto (sequence, frame) for nframes-windowed
    sequence datasets. Counts are clamped like the train/val split domain
    (max(count - nframes, 0)) — the unclamped per-loader copies desynced
    the mapping whenever a sequence was shorter than nframes (round-2
    review finding)."""
    for k, v in frame_counts.items():
        n = max(v - nframes, 0)
        if idx < n:
            return k, idx
        idx -= n
    raise KeyError("Index larger than dataset size")


class NumberPool:
    """Multiprocessing pool that hands each task a tqdm position slot, so
    parallel progress bars render in place (used by the dataset converters).

    Task signature: ``task(ntqdm, *args)``.

    :param processes: worker count; 0 executes inline in the current thread
    :param offset: added to every ntqdm slot (for an outer progress bar)
    """

    def __init__(self, processes, offset=0, *args, **kwargs):
        self._single_thread = processes == 0
        if self._single_thread:
            return
        from tqdm import tqdm

        self._ppool = Pool(processes, initializer=tqdm.set_lock,
                           initargs=(tqdm.get_lock(),), *args, **kwargs)
        self._npool = Manager().Array("B", [0] * processes)
        self._nlock = Manager().Lock()
        self._nqueue = 0
        self._offset = offset
        self._complete_event = Event()

    @staticmethod
    def _wrap_func(func, args, pool, nlock, offset):
        with nlock:
            n = next(i for i, v in enumerate(pool) if v == 0)
            pool[n] = 1
        try:
            return n, func(n + offset, *args), None
        except BaseException as e:  # release the slot via the callback
            return n, None, f"{type(e).__name__}: {e}"

    def apply_async(self, func, args=(), callback=None):
        if self._single_thread:
            result = func(0, *args)
            if callback is not None:
                callback(result)
            return result

        def _wrap_cb(ret):
            # ALWAYS releases the slot and the queue count — a failing task
            # previously leaked both and deadlocked wait_for_once
            n, out, err = ret
            with self._nlock:
                self._npool[n] = 0
                self._nqueue -= 1
            if err is not None:
                print(err)
            elif callback is not None:
                callback(out)
            self._complete_event.set()

        def _err_cb(e):
            # infrastructure failure (unpicklable args etc.): the slot may
            # be leaked, but keep the queue draining
            with self._nlock:
                self._nqueue -= 1
            print(f"{type(e).__name__}: {e}")
            self._complete_event.set()

        with self._nlock:
            self._nqueue += 1
        self._ppool.apply_async(
            NumberPool._wrap_func,
            (func, args, self._npool, self._nlock, self._offset),
            callback=_wrap_cb,
            error_callback=_err_cb,
        )

    def wait_for_once(self, margin=0):
        """Block until a worker slot frees up (when the pool is full)."""
        if self._single_thread:
            return
        if self._nqueue >= len(self._npool) + margin:
            self._complete_event.wait()
        self._complete_event.clear()

    def close(self):
        if not self._single_thread:
            self._ppool.close()

    def join(self):
        if not self._single_thread:
            self._ppool.join()
