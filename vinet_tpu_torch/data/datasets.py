"""Dataset window samplers for training: DHF1K, Hollywood-2/UCF-Sports, the
six audio-visual sets of the STAViS layout and the contiguous chunks of
streaming fine-tuning, ``vinet_tpu/data/datasets.py``.

The same directory layouts, window strides, GT-frame selection, zero-GT
rejection and short-video padding as the JAX package, and the same
``get(idx, rng)`` contract: the same ``np.random.Generator`` gives the same
item, bit for bit. Items are numpy: {"clip": (T, H, W, 3) uint8, "gt": (H, W)
or (Cl, H, W) f32, for SoundDataset with use_sound "audio": (70560, 1) f32};
normalisation runs on the device (``data/pipeline.py``).
"""

from __future__ import annotations

import json
import os
from os.path import join

import numpy as np

from vinet_tpu_torch.data.audio import audio_excerpt, build_audio_index
from vinet_tpu_torch.io.images import MODEL_H, MODEL_W, load_frame, load_map

TRAIN_GT_SIZE = (MODEL_H, MODEL_W)  # train GT is resized to the model's size
AV_DATASETS = ("DIEM", "Coutrot_db1", "Coutrot_db2", "AVAD", "ETMD_av", "SumMe")


def read_fold_list(txt_file: str) -> dict:
    """Parse 'name nframes fps' lines (the reference's read_sal_text)."""
    out = {"names": [], "nframes": [], "fps": []}
    with open(txt_file) as f:
        for line in f:
            w = line.strip().split()
            if not w:
                continue
            out["names"].append(w[0])
            out["nframes"].append(int(w[1]) if len(w) > 1 else 0)
            out["fps"].append(float(w[2]) if len(w) > 2 else 0.0)
    return out


def read_fps_json(json_file: str) -> dict:
    """Parse a DAVE-style {video: fps} map (the reference's read_sal_text_dave)."""
    with open(json_file) as f:
        d = json.load(f)
    return {"names": list(d.keys()), "nframes": [0] * len(d),
            "fps": [float(v) for v in d.values()]}


class DHF1KDataset:
    """DHF1K layout: <root>/<video>/images/%04d.png + maps/%04d.png.

    train: one random window per video, GT = the LAST frame's map at the
    model's size. val: deterministic windows strided 4T, native-size GT.
    save: windows strided T plus a tail window; metadata, no GT.
    alternate=k takes every k-th frame."""

    def __init__(self, path_data, len_snippet, mode="train", multi_frame=0, alternate=1):
        self.path_data = path_data
        self.len_snippet = len_snippet
        self.mode = mode
        self.multi_frame = multi_frame
        self.alternate = alternate
        if mode == "train":
            self.video_names = sorted(os.listdir(path_data))
            self.list_num_frame = [len(os.listdir(join(path_data, v, "images")))
                                   for v in self.video_names]
        else:
            self.list_num_frame = []
            for v in sorted(os.listdir(path_data)):
                n = len(os.listdir(join(path_data, v, "images")))
                span = alternate * len_snippet
                step = 4 * len_snippet if mode == "val" else len_snippet
                for i in range(0, n - span, step):
                    self.list_num_frame.append((v, i))
                if mode != "val":  # save
                    self.list_num_frame.append((v, max(0, n - len_snippet)))

    def __len__(self):
        return len(self.list_num_frame)

    def get(self, idx, rng: np.random.Generator):
        if self.mode == "train":
            name = self.video_names[idx]
            hi = self.list_num_frame[idx] - self.alternate * self.len_snippet + 1
            start = int(rng.integers(0, max(1, hi)))
        else:
            name, start = self.list_num_frame[idx]

        path_clip = join(self.path_data, name, "images")
        path_annt = join(self.path_data, name, "maps")
        clip, gts, size = [], [], None
        for i in range(self.len_snippet):
            fno = start + self.alternate * i + 1
            frame, size = load_frame(join(path_clip, "%04d.png" % fno))
            clip.append(frame)
            if self.mode != "save":
                gts.append(load_map(join(path_annt, "%04d.png" % fno),
                                    size=TRAIN_GT_SIZE if self.mode == "train" else None))
        item = {"clip": np.stack(clip)}
        if self.mode == "save":
            item.update(start_idx=start, name=name, size=size)
        elif self.multi_frame:
            item["gt"] = np.stack(gts)
        else:
            item["gt"] = gts[-1]
        return item


class ChunkDataset:
    """DHF1K-layout contiguous chunks for streaming-consistent fine-tuning
    (``training/streaming_ft.py``): one random (train) or centred (val) run
    of chunk_len model-sized frames per video, with the GT of every frame.
    Videos shorter than chunk_len are skipped.

    Item: {"clip": (N, H, W, 3) uint8, "gts": (N, 224, 384) f32}."""

    def __init__(self, path_data, chunk_len, mode="train"):
        self.path_data = path_data
        self.chunk_len = chunk_len
        self.mode = mode
        self.items = []
        for v in sorted(os.listdir(path_data)):
            n = len(os.listdir(join(path_data, v, "images")))
            if n >= chunk_len:
                self.items.append((v, n))
        if not self.items:
            raise ValueError(f"no videos with >= {chunk_len} frames under {path_data}")

    def __len__(self):
        return len(self.items)

    def get(self, idx, rng: np.random.Generator):
        name, n = self.items[idx]
        if self.mode == "train":
            start = int(rng.integers(0, n - self.chunk_len + 1))
        else:
            start = (n - self.chunk_len) // 2
        clip, gts = [], []
        for i in range(self.chunk_len):
            fno = start + i + 1
            frame, _ = load_frame(join(self.path_data, name, "images", "%04d.png" % fno))
            clip.append(frame)
            gts.append(load_map(join(self.path_data, name, "maps", "%04d.png" % fno),
                                size=TRAIN_GT_SIZE))
        return {"clip": np.stack(clip), "gts": np.stack(gts)}


class HollywoodUCFDataset:
    """Hollywood-2 / UCF-Sports layout (sorted file lists, not fixed
    numbering); short videos are left-padded by repeating the first frame."""

    def __init__(self, path_data, len_snippet, mode="train", multi_frame=0):
        self.path_data = path_data
        self.len_snippet = len_snippet
        self.mode = mode
        self.multi_frame = multi_frame
        if mode == "train":
            self.video_names = sorted(os.listdir(path_data))
            self.list_num_frame = [len(os.listdir(join(path_data, v, "images")))
                                   for v in self.video_names]
        else:
            self.list_num_frame = []
            for v in sorted(os.listdir(path_data)):
                n = len(os.listdir(join(path_data, v, "images")))
                for i in range(0, n - len_snippet, len_snippet):
                    self.list_num_frame.append((v, i))
                if n <= len_snippet:
                    self.list_num_frame.append((v, 0))

    def __len__(self):
        return len(self.list_num_frame)

    def get(self, idx, rng: np.random.Generator):
        if self.mode == "train":
            name = self.video_names[idx]
            start = int(rng.integers(0, max(1, self.list_num_frame[idx] - self.len_snippet + 1)))
        else:
            name, start = self.list_num_frame[idx]

        path_clip = join(self.path_data, name, "images")
        path_annt = join(self.path_data, name, "maps")
        frames = sorted(os.listdir(path_clip))
        sal = sorted(os.listdir(path_annt))
        if len(sal) < self.len_snippet:
            frames = [frames[0]] * (self.len_snippet - len(frames)) + frames
            sal = [sal[0]] * (self.len_snippet - len(sal)) + sal

        clip, gts = [], []
        for i in range(self.len_snippet):
            frame, _ = load_frame(join(path_clip, frames[start + i]))
            clip.append(frame)
            gts.append(load_map(join(path_annt, sal[start + i]),
                                size=TRAIN_GT_SIZE if self.mode == "train" else None))
        gt = np.stack(gts) if self.multi_frame else gts[-1]
        return {"clip": np.stack(clip), "gt": gt}


class SoundDataset:
    """One of the six audio-visual sets (STAViS layout): fold lists under
    <root>/fold_lists/ (DIEM_list_<mode>_fps.txt, else
    <DS>_list_<mode>_<split>_fps.txt), frames under
    video_frames/<DS>/<video>/img_%05d.jpg, GT under
    annotations/<DS>/<video>/maps/eyeMap_%05d.jpg, audio under
    video_audio/<DS>/<video>/<video>.wav.

    train: one window per video, drawn up to 100 times from rng until its
    LAST frame's GT is nonzero (the last draw stands), GT at size. test and
    val: windows strided 2T whose last frame's GT is nonzero, native-size
    GT. use_sound adds each window's excerpt (``data/audio.py``).

    size: the frames' and the train GT's (H, W), the JAX package's fixed
    224 x 384 by default; the train CLI passes the model's input size, so
    that AViNet's fusion geometry matches its data at any size."""

    def __init__(self, path_data, len_snippet, dataset_name="DIEM", split=1, mode="train",
                 use_sound=False, size=TRAIN_GT_SIZE):
        self.path_data = path_data
        self.len_snippet = len_snippet
        self.mode = mode
        self.dataset_name = dataset_name
        self.use_sound = use_sound
        self.size = tuple(size)

        if dataset_name == "DIEM":
            file_name = f"DIEM_list_{mode}_fps.txt"
        else:
            file_name = f"{dataset_name}_list_{mode}_{split}_fps.txt"
        fold = read_fold_list(join(path_data, "fold_lists", file_name))
        self.video_names = sorted(fold["names"])
        self.fps = dict(zip(fold["names"], fold["fps"]))

        self.list_num_frame = []
        if mode == "train":
            self.num_frames = [len(os.listdir(self._maps(v))) for v in self.video_names]
        else:
            for v in self.video_names:
                n = len(os.listdir(self._maps(v)))
                for i in range(0, n - len_snippet, 2 * len_snippet):
                    if self._has_gt(v, i + len_snippet):
                        self.list_num_frame.append((v, i))

        self.audio = {}
        if use_sound:
            nframes = {v: len(os.listdir(self._maps(v))) for v in self.video_names}
            self.audio = build_audio_index(self.video_names, nframes, self.fps,
                                           join(path_data, "video_audio", dataset_name))

    def _maps(self, video) -> str:
        return join(self.path_data, "annotations", self.dataset_name, video, "maps")

    def _has_gt(self, video, frame_no) -> bool:
        return float(load_map(join(self._maps(video), "eyeMap_%05d.jpg" % frame_no)).max()) != 0.0

    def __len__(self):
        return len(self.video_names) if self.mode == "train" else len(self.list_num_frame)

    def get(self, idx, rng: np.random.Generator):
        if self.mode == "train":
            name = self.video_names[idx]
            for _ in range(100):
                start = int(rng.integers(0, max(1, self.num_frames[idx] - self.len_snippet + 1)))
                if self._has_gt(name, start + self.len_snippet):
                    break
        else:
            name, start = self.list_num_frame[idx]

        path_clip = join(self.path_data, "video_frames", self.dataset_name, name)
        clip = [load_frame(join(path_clip, "img_%05d.jpg" % (start + i + 1)), size=self.size)[0]
                for i in range(self.len_snippet)]
        gt = load_map(join(self._maps(name), "eyeMap_%05d.jpg" % (start + self.len_snippet)),
                      size=self.size if self.mode == "train" else None)
        item = {"clip": np.stack(clip), "gt": gt}
        if self.use_sound:
            item["audio"] = audio_excerpt(self.audio.get(name), self.len_snippet, start)
        return item


class ConcatDataset:
    """torch.utils.data.ConcatDataset with the ``get(idx, rng)`` contract:
    the six AV sets as one (the reference's train.py)."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self):
        return int(self.offsets[-1])

    def get(self, idx, rng: np.random.Generator):
        d = int(np.searchsorted(self.offsets, idx, side="right")) - 1
        return self.datasets[d].get(idx - int(self.offsets[d]), rng)
