"""Streaming input helpers for live/demo use.

The port's own copy of devo_tpu/data/stream.py: the counterpart of upstream
DEVO's devo/stream.py (image/video queue streamers) and utils/bag_utils.py
(rosbag readers). Producers run in background threads and push (timestamp,
voxel/frame, intrinsics) tuples into a bounded queue so that the engine
never stalls on IO; a sentinel None marks end-of-stream. The rosbag reader
needs the `rosbags` package, imported when the stream starts.
"""
from __future__ import annotations

import glob
import os
import queue
import threading
from typing import Iterator, Optional, Tuple

import numpy as np


def _producer(iterator, q: "queue.Queue", stop: "threading.Event"):
    # ALWAYS terminate the queue: an iterator error must surface in the
    # consumer (re-raised below), not strand it on q.get() forever. The
    # bounded put()s poll `stop` so a consumer that exits early (gen.close /
    # GC) releases the thread instead of leaving it blocked on a full queue.
    def put(item):
        while not stop.is_set():
            try:
                q.put(item, timeout=0.25)
                return True
            except queue.Full:
                continue
        return False

    try:
        for item in iterator:
            if not put(item):
                return
        put(None)
    except BaseException as e:  # noqa: BLE001 — relayed, not swallowed
        put(e)


def buffered(iterator, maxsize: int = 8) -> Iterator:
    """Wrap any (ts, data, intrinsics) iterator with a prefetch thread
    (mirrors the reference's multiprocessing readers, load_utils.py:119-131).
    Iterator exceptions propagate to the consumer."""
    q: "queue.Queue" = queue.Queue(maxsize=maxsize)
    stop = threading.Event()
    t = threading.Thread(target=_producer, args=(iterator, q, stop),
                         daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()


def image_stream(imagedir: str, calib: np.ndarray, stride: int = 1,
                 skip: int = 0):
    """Directory-of-images streamer (devo/stream.py:7-47 analog)."""
    import cv2

    K = np.asarray(calib[:4], np.float32)
    files = sorted(glob.glob(os.path.join(imagedir, "*.png"))
                   + glob.glob(os.path.join(imagedir, "*.jpg")))[skip::stride]
    for t, fn in enumerate(files):
        img = cv2.imread(fn)
        if len(calib) > 4:
            kmat = np.eye(3)
            kmat[0, 0], kmat[1, 1], kmat[0, 2], kmat[1, 2] = K
            img = cv2.undistort(img, kmat, np.asarray(calib[4:]))
        yield t, img, K


def video_stream(videofile: str, calib: np.ndarray, stride: int = 1,
                 skip: int = 0):
    """Video-file streamer (devo/stream.py:50-87 analog)."""
    import cv2

    K = np.asarray(calib[:4], np.float32)
    cap = cv2.VideoCapture(videofile)
    t = 0
    idx = 0
    while True:
        ok, img = cap.read()
        if not ok:
            break
        if idx >= skip and (idx - skip) % stride == 0:
            yield t, img, K
            t += 1
        idx += 1
    cap.release()


def rosbag_event_stream(bagfile: str, topic: str, H: int, W: int,
                        intrinsics: np.ndarray,
                        window_us: float = 1e4, bins: int = 5):
    """Rosbag event streamer (utils/bag_utils.py analog) — requires the
    optional `rosbags` package; voxelizes fixed-duration event windows.

    Yields (voxel (bins, H, W), intrinsics (4,), timestamp_s) — the same
    tuple order every engine-facing iterator uses (eval/harness.run_voxel
    unpacks `voxel, intrinsics, tss`). The tail window (shorter than
    window_us) is flushed at end-of-bag."""
    try:
        from rosbags.highlevel import AnyReader
        from pathlib import Path
    except ImportError as e:  # pragma: no cover
        raise ImportError("rosbag streaming requires the 'rosbags' package") from e

    from .event_utils import to_voxel_grid

    intr = np.asarray(intrinsics, np.float32)[:4]

    def flush(buf_x, buf_y, buf_t, buf_p, t0):
        vox = to_voxel_grid(np.asarray(buf_x, np.float32),
                            np.asarray(buf_y, np.float32),
                            np.asarray(buf_t, np.int64),
                            np.asarray(buf_p, np.int8), H, W, bins)
        return vox, intr, t0 / 1e6

    with AnyReader([Path(bagfile)]) as reader:
        conns = [c for c in reader.connections if c.topic == topic]
        buf_x, buf_y, buf_t, buf_p = [], [], [], []
        t0 = None
        for conn, ts, raw in reader.messages(connections=conns):
            msg = reader.deserialize(raw, conn.msgtype)
            for ev in msg.events:
                tus = ev.ts.sec * 1_000_000 + ev.ts.nanosec // 1000
                if t0 is None:
                    t0 = tus
                buf_x.append(ev.x)
                buf_y.append(ev.y)
                buf_t.append(tus)
                buf_p.append(1 if ev.polarity else -1)
                if tus - t0 >= window_us:
                    yield flush(buf_x, buf_y, buf_t, buf_p, t0)
                    buf_x, buf_y, buf_t, buf_p = [], [], [], []
                    t0 = None
        if buf_x:
            yield flush(buf_x, buf_y, buf_t, buf_p, t0)
