"""Annotation parsers: labelimg (PascalVOC XML) and labelme (JSON).

A copy of tf2_yolo_tpu/data/parsers.py (pure numpy and the standard
library; the port imports nothing of the JAX package).

The reference parses XML with BeautifulSoup (utils/tools.py:230-261)
and labelme JSON (tools.py:263-299). Here XML goes through the stdlib
ElementTree (no bs4 dependency) with identical extraction semantics:
only objects whose name is in ``class_names`` are kept, pixel corners
are divided by the (original/resized) zoom ratio, labelme boxes take
points[0] as (x1, y1) and points[1] as (x2, y2), and base64
``imageData`` is used when no image folder is given.
"""

import base64
import json
import xml.etree.ElementTree as ET
from io import BytesIO

import numpy as np


def parse_labelimg(xml_path, class_names, encoding="big5"):
    """Parse one labelimg XML file.

    Returns:
        (boxes, labels): boxes float (N, 4) xyxy in original pixels,
        labels int list of class indices.
    """
    with open(xml_path, encoding=encoding) as file:
        root = ET.fromstring(file.read())

    boxes, labels = [], []
    for obj in root.iter("object"):
        name = obj.findtext("name")
        if name not in class_names:
            continue
        labels.append(class_names.index(name))
        bnd = obj.find("bndbox")
        boxes.append([int(bnd.findtext("xmin")),
                      int(bnd.findtext("ymin")),
                      int(bnd.findtext("xmax")),
                      int(bnd.findtext("ymax"))])
    boxes = (np.asarray(boxes, dtype=float) if boxes
             else np.zeros((0, 4)))
    return boxes, labels


def parse_labelme(json_path, class_names, encoding="big5"):
    """Parse one labelme JSON file.

    Returns:
        (boxes, labels, image_data): boxes float (N, 4) xyxy in
        original pixels; image_data is decoded bytes of the embedded
        base64 image or None.
    """
    with open(json_path, encoding=encoding) as file:
        data = json.load(file)

    boxes, labels = [], []
    for shape in data.get("shapes", []):
        if shape.get("shape_type") != "rectangle":
            continue
        name = shape.get("label")
        if name not in class_names:
            continue
        labels.append(class_names.index(name))
        pts = np.asarray(shape["points"], dtype=float)
        boxes.append([pts[0, 0], pts[0, 1], pts[1, 0], pts[1, 1]])

    image_data = None
    if data.get("imageData"):
        image_data = BytesIO(base64.b64decode(data["imageData"]))

    boxes = (np.asarray(boxes, dtype=float) if boxes
             else np.zeros((0, 4)))
    return boxes, labels, image_data
