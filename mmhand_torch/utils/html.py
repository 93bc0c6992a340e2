"""Static HTML training gallery (counterpart of mmhand_tpu/utils/html.py;
reference util/html.py:1-64 + util/visualizer.py:78-97, without the
dominate dependency)."""

from __future__ import annotations

import html
import os


class HTMLGallery:
    """Collects (title, [(image_rel_path, caption), ...]) rows and writes a
    single index.html next to the image dir."""

    def __init__(self, web_dir: str, title: str = "training snapshots"):
        self.web_dir = web_dir
        self.img_dir = os.path.join(web_dir, "images")
        self.title = title
        self.rows: list = []
        os.makedirs(self.img_dir, exist_ok=True)

    def add_header(self, text: str) -> None:
        self.rows.append(("header", text))

    def add_images(self, images, captions, width: int = 512) -> None:
        self.rows.append(("images", list(zip(images, captions)), width))

    def save(self) -> str:
        parts = [f"<!DOCTYPE html><html><head><meta charset='utf-8'>"
                 f"<title>{html.escape(self.title)}</title>"
                 "<style>body{font-family:sans-serif;background:#fafafa}"
                 "td{padding:4px;text-align:center;font-size:12px}</style>"
                 "</head><body>",
                 f"<h1>{html.escape(self.title)}</h1>"]
        for row in self.rows:
            if row[0] == "header":
                parts.append(f"<h3>{html.escape(row[1])}</h3>")
            else:
                _, pairs, width = row
                cells_img, cells_txt = [], []
                for img, cap in pairs:
                    cells_img.append(
                        f"<td><a href='images/{img}'>"
                        f"<img src='images/{img}' width='{width}'></a></td>")
                    cells_txt.append(f"<td>{html.escape(str(cap))}</td>")
                parts.append("<table><tr>" + "".join(cells_img)
                             + "</tr><tr>" + "".join(cells_txt)
                             + "</tr></table>")
        parts.append("</body></html>")
        out = os.path.join(self.web_dir, "index.html")
        with open(out, "w") as f:
            f.write("\n".join(parts))
        return out
