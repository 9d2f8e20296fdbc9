"""Write the 1280x720 JPEG fixtures and the sha256 of cv2's decode of each.

    python tests/data/torch_jpeg/make_fixtures.py

Needs cv2 (the dev box). Frames like BDD100K's: smooth colour fields,
pixel noise and flat boxes, drawn from a seed; encoded by cv2 at three
operating points (quality, sampling, restart interval). ``hashes.json``
maps each file to the sha256 of cv2's decode (RGB uint8, C order), which
the port's decoder must reproduce on any machine
(``tests/test_torch_image_codec.py``, ``chip_smoke.py`` phase 10).
"""

import hashlib
import json
import pathlib

import cv2
import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
FIXTURES = {"bdd_q90_420.jpg": (90, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420, 0),
            "bdd_q95_444.jpg": (95, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444, 0),
            "bdd_q75_422_rst.jpg": (75, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422, 8)}


def frame(seed: int, h: int = 720, w: int = 1280) -> np.ndarray:
    rng = np.random.RandomState(seed)
    low = rng.randint(0, 255, (h // 40, w // 40, 3), np.uint8)
    img = cv2.resize(low, (w, h), interpolation=cv2.INTER_CUBIC).astype(np.int16)
    img += rng.randint(-10, 10, img.shape).astype(np.int16)
    for _ in range(12):
        y, x = rng.randint(0, h - 120), rng.randint(0, w - 200)
        img[y:y + rng.randint(20, 120), x:x + rng.randint(20, 200)] = rng.randint(0, 256, 3)
    return np.clip(img, 0, 255).astype(np.uint8)


def main():
    hashes = {}
    for seed, (name, (quality, sampling, restart)) in enumerate(FIXTURES.items()):
        ok, buf = cv2.imencode(".jpg", frame(seed), [
            cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sampling,
            cv2.IMWRITE_JPEG_RST_INTERVAL, restart])
        assert ok
        (HERE / name).write_bytes(buf.tobytes())
        rgb = cv2.cvtColor(cv2.imdecode(buf, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
        hashes[name] = hashlib.sha256(np.ascontiguousarray(rgb).tobytes()).hexdigest()
    (HERE / "hashes.json").write_text(json.dumps(hashes, indent=1) + "\n")


if __name__ == "__main__":
    main()
