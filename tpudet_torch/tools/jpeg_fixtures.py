"""Write the JPEG fixtures that the port's decoder is tested on.

    python -m tpudet_torch.tools.jpeg_fixtures [OUT_DIR]

``OUT_DIR`` defaults to ``tests/torch_fixtures/jpeg``. Each fixture is a
scene of filled rectangles, ellipses and triangles on a smooth gradient,
drawn from a numpy seed as ``tools/misc/synth_shapes.py`` draws its
shapes (flat colours, not noise, so that the files stay small), and
written by cv2 in one of the JPEG forms the decoder must read: baseline
4:2:0 at several sizes (a downscale, an upscale and the identity of the
640 letterbox, odd sizes and a 1-pixel-high strip), grayscale, 4:4:4,
progressive and with restart markers. ``truncated.jpg`` is a baseline file
cut inside its scan header, which every decoder refuses.

Beside them: ``decoded.npz``, cv2's ``imdecode(..., IMREAD_COLOR)`` of each
fixture under its file name (what the card's decoder is held against
where cv2 is not installed), and ``manifest.json``, each fixture's
size, form and shapes as COCO boxes and 0-based labels.

Needs cv2; nothing of the port imports this module.
"""
import argparse
import json
import os

import numpy as np

CLASSES = ('rect', 'circle', 'triangle')
DEFAULT_OUT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), 'tests', 'torch_fixtures', 'jpeg')
QUALITY = 90
SEED = 0

# name -> (h, w, form); forms: '420' baseline, 'gray', '444',
# 'progressive', 'restart'
FIXTURES = {
    'rgb_480x640.jpg': (480, 640, '420'),
    'rgb_640x480.jpg': (640, 480, '420'),
    'rgb_720x1280.jpg': (720, 1280, '420'),
    'rgb_1080x1920.jpg': (1080, 1920, '420'),
    'rgb_96x128.jpg': (96, 128, '420'),
    'rgb_640x640.jpg': (640, 640, '420'),
    'rgb_123x457.jpg': (123, 457, '420'),
    'rgb_1x64.jpg': (1, 64, '420'),
    'gray_480x640.jpg': (480, 640, 'gray'),
    's444_375x500.jpg': (375, 500, '444'),
    'progressive_427x640.jpg': (427, 640, 'progressive'),
    'restart_333x500.jpg': (333, 500, 'restart'),
}
TRUNCATED = 'truncated.jpg'


def scene(h, w, seed):
    """A BGR uint8 scene and its shapes ``[(label, [x, y, w, h])]``."""
    import cv2
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    c0, c1 = rng.randint(20, 120, 3), rng.randint(20, 120, 3)
    t = (xx / max(w - 1, 1) + yy / max(h - 1, 1)) / 2
    img = (c0 + (c1 - c0) * t[..., None]).astype(np.uint8)
    shapes = []
    for _ in range(rng.randint(3, 8) if h > 16 else 0):
        cls = rng.randint(3)
        bw = rng.randint(max(w // 10, 2), max(w // 3, 3))
        bh = rng.randint(max(h // 10, 2), max(h // 3, 3))
        x, y = rng.randint(0, w - bw), rng.randint(0, h - bh)
        color = tuple(int(c) for c in rng.randint(120, 256, 3))
        if cls == 0:
            cv2.rectangle(img, (x, y), (x + bw, y + bh), color, -1)
        elif cls == 1:
            cv2.ellipse(img, (x + bw // 2, y + bh // 2), (bw // 2, bh // 2),
                        0, 0, 360, color, -1)
        else:
            pts = np.array([[x + bw // 2, y], [x, y + bh], [x + bw, y + bh]])
            cv2.fillConvexPoly(img, pts, color)
        shapes.append((int(cls), [float(x), float(y), float(bw), float(bh)]))
    return img, shapes


def encode(img, form):
    import cv2
    params = [cv2.IMWRITE_JPEG_QUALITY, QUALITY]
    if form == 'gray':
        img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    elif form == '444':
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                   cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444]
    elif form == 'progressive':
        params += [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
    elif form == 'restart':
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, 4]
    ok, buf = cv2.imencode('.jpg', img, params)
    if not ok:
        raise RuntimeError(f'cv2 could not encode a {form} JPEG')
    return buf.tobytes()


def cut_in_scan_header(data: bytes) -> bytes:
    """``data`` cut 4 bytes into its first SOS segment."""
    sos = data.find(b'\xff\xda')
    if sos < 0:
        raise ValueError('no SOS marker')
    return data[:sos + 4]


def write(out_dir):
    import cv2
    os.makedirs(out_dir, exist_ok=True)
    manifest, decoded = {}, {}
    for i, (name, (h, w, form)) in enumerate(sorted(FIXTURES.items())):
        img, shapes = scene(h, w, SEED + i)
        data = encode(img, form)
        with open(os.path.join(out_dir, name), 'wb') as f:
            f.write(data)
        decoded[name] = cv2.imdecode(np.frombuffer(data, np.uint8),
                                     cv2.IMREAD_COLOR)
        manifest[name] = dict(height=h, width=w, form=form,
                              labels=[s[0] for s in shapes],
                              bboxes=[s[1] for s in shapes])
    with open(os.path.join(out_dir, 'rgb_480x640.jpg'), 'rb') as f:
        truncated = cut_in_scan_header(f.read())
    with open(os.path.join(out_dir, TRUNCATED), 'wb') as f:
        f.write(truncated)
    manifest[TRUNCATED] = dict(form='truncated', source='rgb_480x640.jpg',
                               bytes=len(truncated))
    np.savez_compressed(os.path.join(out_dir, 'decoded.npz'), **decoded)
    with open(os.path.join(out_dir, 'manifest.json'), 'w') as f:
        json.dump(dict(classes=list(CLASSES), quality=QUALITY, seed=SEED,
                       fixtures=manifest), f, indent=1, sort_keys=True)
    return manifest


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('out_dir', nargs='?', default=DEFAULT_OUT)
    args = p.parse_args(argv)
    manifest = write(args.out_dir)
    total = sum(os.path.getsize(os.path.join(args.out_dir, n))
                for n in os.listdir(args.out_dir))
    print(f'{len(manifest)} fixtures, {total / 2**20:.2f} MiB in '
          f'{args.out_dir}')


if __name__ == '__main__':
    main()
