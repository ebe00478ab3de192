"""Writers of a COCO-format set (a json, loaded, and its images) in the
layouts of the other datasets, for the tests and ``chip_smoke.py``, and to
try those datasets on data at hand:

- ``write_voc(coco, img_dir, out)``: ``out/{Annotations,JPEGImages,
  ImageSets/Main/test.txt}``, one XML a image, for ``XMLDataset``/
  ``VOCDataset`` (``ann_file`` the split, ``img_prefix`` out);
- ``write_custom(coco, out)``: ``out/ann.json``, the ``CustomDataset``
  list (labels index the json's categories in order), for
  ``CustomDataset`` and ``GarbageDataset`` (``img_prefix`` img_dir);
- ``write_circle(coco, img_dir, out)``: ``out/<stem>.circle`` and
  ``<stem>.jpg`` beside it, for ``TrafficSignDataset`` (``ann_file`` and
  ``img_prefix`` out; one class, each line ``x1,y1,x2,y2,difficulty``);
- ``write_lvis(coco, out)``: ``out/ann.json``, the COCO json with LVIS's
  category fields, for ``LVISDataset`` (``img_prefix`` img_dir).

Crowd gts are left out of every layout but ``lvis``. Pass the dataset the
json's category names as ``classes=`` where its own class names differ.
"""
import json
import os
import shutil
from typing import Callable, Dict, Optional


def _stem(name: str) -> str:
    return os.path.splitext(os.path.basename(name))[0]


def _by_image(coco: Dict) -> Dict[int, list]:
    out = {im['id']: [] for im in coco['images']}
    for a in coco['annotations']:
        if not a.get('iscrowd', 0):
            out[a['image_id']].append(a)
    return out


def _xyxy(a) -> list:
    x, y, w, h = a['bbox']
    return [x, y, x + w, y + h]


def write_voc(coco: Dict, img_dir: str, out: str,
              difficult: Optional[Callable[[Dict], bool]] = None) -> str:
    """The VOC tree; ``difficult(ann)`` marks objects difficult. Returns
    the split file's path."""
    names = {c['id']: c['name'] for c in coco['categories']}
    for d in ('Annotations', 'JPEGImages', 'ImageSets/Main'):
        os.makedirs(os.path.join(out, d), exist_ok=True)
    anns = _by_image(coco)
    ids = []
    for im in coco['images']:
        stem = _stem(im['file_name'])
        ids.append(stem)
        shutil.copyfile(os.path.join(img_dir, im['file_name']),
                        os.path.join(out, 'JPEGImages', stem + '.jpg'))
        objects = []
        for a in anns[im['id']]:
            box = ''.join(f'<{t}>{v!r}</{t}>' for t, v in zip(
                ('xmin', 'ymin', 'xmax', 'ymax'), _xyxy(a)))
            flag = int(bool(difficult and difficult(a)))
            objects.append(f'<object><name>{names[a["category_id"]]}</name>'
                           f'<difficult>{flag}</difficult>'
                           f'<bndbox>{box}</bndbox></object>')
        with open(os.path.join(out, 'Annotations', stem + '.xml'), 'w') as f:
            f.write(f'<annotation><filename>{stem}.jpg</filename><size>'
                    f'<width>{im["width"]}</width><height>{im["height"]}'
                    f'</height><depth>3</depth></size>{"".join(objects)}'
                    f'</annotation>\n')
    split = os.path.join(out, 'ImageSets', 'Main', 'test.txt')
    with open(split, 'w') as f:
        f.write(''.join(i + '\n' for i in ids))
    return split


def write_custom(coco: Dict, out: str) -> str:
    """The ``CustomDataset`` json; returns its path."""
    label = {c['id']: i for i, c in enumerate(coco['categories'])}
    anns = _by_image(coco)
    infos = [dict(filename=im['file_name'], width=im['width'],
                  height=im['height'],
                  ann=dict(bboxes=[_xyxy(a) for a in anns[im['id']]],
                           labels=[label[a['category_id']]
                                   for a in anns[im['id']]]))
             for im in coco['images']]
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, 'ann.json')
    with open(path, 'w') as f:
        json.dump(infos, f)
    return path


def write_circle(coco: Dict, img_dir: str, out: str,
                 difficulty: Optional[Callable[[Dict], int]] = None) -> str:
    """The ``.circle`` folder (each gt's difficulty from
    ``difficulty(ann)``, 0 without it); returns the folder."""
    os.makedirs(out, exist_ok=True)
    anns = _by_image(coco)
    for im in coco['images']:
        stem = _stem(im['file_name'])
        shutil.copyfile(os.path.join(img_dir, im['file_name']),
                        os.path.join(out, stem + '.jpg'))
        with open(os.path.join(out, stem + '.circle'), 'w') as f:
            for a in anns[im['id']]:
                f.write(','.join(repr(v) for v in _xyxy(a)) +
                        f',{difficulty(a) if difficulty else 0}\n')
    return out


def write_lvis(coco: Dict, out: str) -> str:
    """The json with LVIS's category fields; returns its path."""
    cats = [dict(c, synset=c['name'], frequency='f', image_count=0,
                 instance_count=0) for c in coco['categories']]
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, 'ann.json')
    with open(path, 'w') as f:
        json.dump(dict(coco, categories=cats), f)
    return path

