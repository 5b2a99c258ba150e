"""VOC-XML -> annotation-txt converter (reference xml_to_txt.py:1-42).

A copy of ``yolov4tpu.tools.xml_to_txt``, as a CLI:

    python -m yolov4tpu_torch.tools.xml_to_txt --xml-dir DIR \
        --classes classes.txt --output anno.txt [--img-ext .jpg]

Output line format: ``img_name.jpg x1,y1,x2,y2,cls x1,y1,x2,y2,cls ...``
"""

from __future__ import annotations

import argparse
import os
import xml.etree.ElementTree as ET
from glob import glob


def convert(xml_dir: str, class_names, output_path: str,
            img_ext: str = ".jpg") -> int:
    """Convert all XMLs in xml_dir; returns number of images written."""
    name_to_idx = {n: i for i, n in enumerate(class_names)}
    count = 0
    with open(output_path, "w") as out:
        for xml_path in sorted(glob(os.path.join(xml_dir, "*.xml"))):
            root = ET.parse(xml_path).getroot()
            fname = root.findtext("filename")
            if fname is None:
                fname = os.path.basename(xml_path)[:-4] + img_ext
            objs = []
            for obj in root.iter("object"):
                cls = obj.findtext("name")
                if cls not in name_to_idx:
                    continue
                box = obj.find("bndbox")
                coords = [box.findtext(k) for k in
                          ("xmin", "ymin", "xmax", "ymax")]
                objs.append(",".join([str(int(float(c))) for c in coords]
                                     + [str(name_to_idx[cls])]))
            if objs:
                out.write(fname + " " + " ".join(objs) + "\n")
                count += 1
    return count


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--xml-dir", required=True)
    p.add_argument("--classes", required=True,
                   help="txt file with one class name per line")
    p.add_argument("--output", required=True)
    p.add_argument("--img-ext", default=".jpg")
    args = p.parse_args(argv)
    with open(args.classes) as f:
        class_names = [line.strip() for line in f if line.strip()]
    n = convert(args.xml_dir, class_names, args.output, args.img_ext)
    print(f"wrote {n} annotation lines to {args.output}")


if __name__ == "__main__":
    main()
