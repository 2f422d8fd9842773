"""Class-name vocabularies shipped with the port: the package's own
copies of the COCO (80), Pascal VOC (20) and ImageNet (1000) lists of
tf2_yolo_tpu/assets/."""

import os
import re

_HERE = os.path.dirname(os.path.abspath(__file__))


def load_class_names(name="coco", with_synsets=False):
    """Load a bundled class list: "coco" (80), "voc" (20), or
    "imagenet" (1000 ILSVRC2012 entries, devkit order, lines of
    "synset_id,name"), or a path to a newline-separated file.

    Lines starting with a WordNet synset id ("nNNNNNNNN,") are split
    as "synset,name" and the name part is returned; pass
    ``with_synsets=True`` for (synset, name) tuples ((None, line) for
    the other lines). Other comma-containing lines (user class names
    like "tv,monitor") are returned whole."""
    path = name
    if not os.path.isfile(path):
        path = os.path.join(_HERE, f"{name}_classnames.txt")
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if re.match(r"n\d{8},", line):
                synset, cname = line.split(",", 1)
                out.append((synset, cname) if with_synsets else cname)
            else:
                out.append((None, line) if with_synsets else line)
    return out
