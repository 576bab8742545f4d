"""Real-video ingestion: convert footage to the synthetic camera's heatmap
format (a copy of `bcnf_tpu/simulation/video_processing.py`: host-side NumPy,
the same in both packages; SURVEY.md section 2.3).

Reference `src/bcnf/simulation/video_processing.py:10-126`:
background subtraction against the time average, block-average downscale to
the simulated `(H, W) = (ratio[1]*10, ratio[0]*10)` resolution, double
thresholding (pixel < 100, frame sum < 1500), and an optional per-frame
1-component GMM resampling step (`gmm_approximation`). GIF writing is
delegated to `bcnf_tpu_torch.plots.debug_plotting.make_gif` instead of being inline.

cv2/sklearn are imported lazily so the core framework has no hard dependency.
"""

from __future__ import annotations

import numpy as np

PIXEL_THRESHOLD = 100.0  # reference `video_processing.py:95` (arbitrary, documented)
FRAME_SUM_THRESHOLD = 1500.0  # reference `video_processing.py:100`


def gmm_approximation(
    frames: np.ndarray,
    ratio: tuple[int, int] = (16, 9),
    n_mc_samples: int = 5000,
    random_state: int = 42,
) -> np.ndarray:
    """Per-frame single-Gaussian resampling into a histogram heatmap
    (reference `gmm_approximation`, `video_processing.py:10-49`)."""
    from sklearn.mixture import GaussianMixture

    H, W = ratio[1] * 10, ratio[0] * 10
    gmm = GaussianMixture(n_components=1, covariance_type="spherical", random_state=random_state)
    heatmaps = []
    for frame in frames:
        if np.sum(frame) != 0:
            gmm.fit(np.argwhere(frame != 0))
            sample, _ = gmm.sample(n_mc_samples)
            hist, _, _ = np.histogram2d(
                sample[:, 0], sample[:, 1], bins=(H, W), range=((0, H), (0, W))
            )
            heatmaps.append(hist / np.sum(hist))
        else:
            heatmaps.append(np.zeros((H, W)))
    return np.asarray(heatmaps)


def process_video(
    video_path: str,
    use_gmm_approximation: bool = True,
    ratio: tuple[int, int] = (16, 9),
) -> np.ndarray:
    """Convert real footage to `(T, H, W)` normalized heatmaps
    (reference `process_video`, `video_processing.py:52-126`)."""
    import cv2

    cap = cv2.VideoCapture(video_path)
    width = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    frames = []
    while cap.isOpened():
        ret, frame = cap.read()
        if not ret:
            break
        frames.append(frame)
    cap.release()
    # the last frame is often corrupt (reference `video_processing.py:71`)
    frames = np.asarray(frames[:-1], dtype=np.float64)

    time_average = np.mean(frames, axis=0)
    frame_diff = np.sqrt(np.sum((frames - time_average) ** 2, axis=3))

    H, W = ratio[1] * 10, ratio[0] * 10
    factor = int(width / W)
    h_blocks = frame_diff.shape[1] // factor
    w_blocks = frame_diff.shape[2] // factor
    cropped = frame_diff[:, : h_blocks * factor, : w_blocks * factor]
    blocks = cropped.reshape(len(frames), h_blocks, factor, w_blocks, factor)
    resized = blocks.mean(axis=(2, 4))[:, :H, :W]

    resized[resized < PIXEL_THRESHOLD] = 0.0
    sums = resized.sum(axis=(1, 2))
    out = np.where(
        (sums < FRAME_SUM_THRESHOLD)[:, None, None],
        0.0,
        resized / np.where(sums > 0, sums, 1.0)[:, None, None],
    )

    if use_gmm_approximation:
        return gmm_approximation(out, ratio)
    return out


def video_to_tensor(video_path: str, greyscale: bool = False, dtype: str = "float32") -> np.ndarray:
    """Load a video into a `(T, H, W)` greyscale array
    (reference `src/bcnf/vid_to_tensor/vid_to_tensor.py:5-31`, via OpenCV
    instead of torchvision)."""
    import cv2

    cap = cv2.VideoCapture(video_path)
    frames = []
    while cap.isOpened():
        ret, frame = cap.read()
        if not ret:
            break
        frames.append(frame)
    cap.release()
    video = np.asarray(frames, dtype=dtype)
    if not greyscale:
        # match the reference quirk: the channel mean is taken when the input
        # is NOT already greyscale (reference `vid_to_tensor.py:27-29`)
        video = video.mean(axis=3)
    return video


def two_camera_videos_to_tensor(
    video_path1: str, video_path2: str, greyscale: bool = False, dtype: str = "float32"
) -> np.ndarray:
    """Stack two camera videos into `(T, 2, H, W)` with frame-count matching
    (reference `vid_to_tensor.py:34-71`)."""
    v1 = video_to_tensor(video_path1, greyscale, dtype)
    v2 = video_to_tensor(video_path2, greyscale, dtype)
    n = min(len(v1), len(v2))
    return np.stack([v1[:n], v2[:n]], axis=1)
