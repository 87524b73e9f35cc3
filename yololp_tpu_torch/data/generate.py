"""Synthetic Chinese license-plate generator with corner tracking.

Behavioral reference: yolov6/data/generate/{Blue,Green_S,Green_B,Yellow_S,
utils,generate}.py — four plate styles (blue 7-char, small/big new-energy
green 8-char, yellow 7-char), rendered glyph-by-glyph, then distorted
(perspective, HSV jitter, background composite, blur, noise) with the 4
plate corners tracked through every transform; plus the two in-image uses:
  * warp_into_image: re-synthesize the plate inside each labeled corner quad
    (generate/generate.py:529 generate_one),
  * paste_plates: paste 0-3 resized plates into non-overlapping regions
    (datasets.py:441 get_paste_generate).

Redesigned rather than ported: plate backgrounds are procedural (the
reference loads template .bmp assets; we synthesize style-colored canvases),
CJK glyphs (provinces, 警/学) come from the authored vector stroke library
(data/glyphs.py — the reference repo ships only a latin font and its own
generator crashes on the missing `platech.ttf`), and latin glyphs use the
freely-licensed DejaVu font. Pass `cjk_font_path` to use a real CJK font.

Label row format (pixel coords, (1, 20)):
  [pro, alp, ads0..5, x1, y1, x2, y2, cx1, cy1 .. cx4, cy4]

Copied from yololp_tpu/data/generate.py (the port imports nothing of the JAX
package); cv2 and PIL are imported inside the functions that use them,
since the machine with the card has neither.
"""

from __future__ import annotations

import math
import os
from typing import List, Optional, Tuple

import numpy as np

from yololp_tpu_torch.data import glyphs as glyph_lib
from yololp_tpu_torch.data.vocab import ADS_NAMES, ALP_NAMES, PRO_NAMES

# style-appearance constants: (bg BGR, fg BGR)
STYLE_COLORS = {
    "blue": ((180, 90, 20), (255, 255, 255)),
    "green_s": ((160, 240, 200), (20, 20, 20)),
    "green_b": ((120, 230, 170), (20, 20, 20)),
    "yellow": ((40, 200, 250), (20, 20, 20)),
}


def _rint(rng, val) -> int:
    return int(rng.random() * val)


class GlyphRenderer:
    """Renders a 70px-tall glyph as a (70, w) uint8 alpha mask.

    Fonts are loaded lazily so the object stays picklable (dataloader
    workers run under a spawn multiprocessing context)."""

    def __init__(self, cjk_font_path: Optional[str] = None):
        self.cjk_font_path = cjk_font_path
        self._latin = None
        self._cjk = None
        self._cache = {}

    def __getstate__(self):
        return {"cjk_font_path": self.cjk_font_path}

    def __setstate__(self, state):
        self.__init__(state["cjk_font_path"])

    @property
    def latin(self):
        from PIL import ImageFont

        if self._latin is None:
            path = glyph_lib.find_latin_font()
            self._latin = (ImageFont.truetype(path, 280) if path
                           else ImageFont.load_default())
        return self._latin

    @property
    def cjk(self):
        from PIL import ImageFont

        if self._cjk is None and self.cjk_font_path and os.path.isfile(
                self.cjk_font_path):
            try:
                self._cjk = ImageFont.truetype(self.cjk_font_path, 43)
            except OSError:
                self.cjk_font_path = None
        return self._cjk

    def latin_glyph(self, ch: str, w: int = 23) -> np.ndarray:
        key = ("latin", ch, w)
        if key not in self._cache:
            self._cache[key] = glyph_lib.render_latin(ch, w, 70, self.latin)
        return self._cache[key]

    def cjk_glyph(self, ch: str, w: int = 23) -> np.ndarray:
        from PIL import Image, ImageDraw

        if self.cjk is not None:
            img = Image.new("L", (45, 70), 0)
            ImageDraw.Draw(img).text((0, 3), ch, 255, font=self.cjk)
            return np.asarray(img.resize((w, 70)))
        key = ("cjk", ch, w)
        if key not in self._cache:
            self._cache[key] = glyph_lib.render_glyph(ch, w, 70)
        return self._cache[key]


class PlateStyle:
    """One plate style: vocabulary constraints + canvas layout."""

    def __init__(self, name: str, n_chars: int, pro_lo: int, pro_hi: int,
                 alp_lo: int, ads_hi: int, force_last_ads: Optional[int] = None):
        self.name = name
        self.n_chars = n_chars      # rendered chars (7 or 8)
        self.pro_lo, self.pro_hi = pro_lo, pro_hi
        self.alp_lo = alp_lo
        self.ads_hi = ads_hi
        self.force_last_ads = force_last_ads


# vocabulary windows mirror the reference generators: Blue deletes 皖A
# (pro[1:31], alp[1:], ads[:34]); green styles use the full 8 slots.
STYLES = {
    "blue": PlateStyle("blue", 7, 1, 31, 1, 34),
    "green_s": PlateStyle("green_s", 8, 0, 31, 0, 34),
    "green_b": PlateStyle("green_b", 8, 0, 31, 0, 34),
    "yellow": PlateStyle("yellow", 7, 1, 31, 1, 34),
}
STYLE_PROBS = [("blue", 0.48), ("green_s", 0.32), ("yellow", 0.12),
               ("green_b", 0.08)]  # datasets.py:455-463 thresholds
ADS_PAD = 36  # 'O' class pads slot 8 of 7-char plates (Blue.py:50)


class PlateGenerator:
    """Generates (plate_bgr (72, 272, 3), label (1, 20), mask (72, 272))."""

    SIZE = (272, 72)  # (w, h)

    def __init__(self, seed: Optional[int] = None,
                 cjk_font_path: Optional[str] = None,
                 env_images: Optional[List[str]] = None,
                 diversity: float = 0.0):
        self.rng = np.random.default_rng(seed)
        self.glyphs = GlyphRenderer(cjk_font_path)
        self.env_images = env_images or []
        # 0 = deterministic canonical glyphs (golden-stable); >0 enables
        # per-instance glyph weathering: stroke-width jitter on the authored
        # CJK set, erosion/dilation, cutout occlusions (dirt/bolts), and
        # per-char rotation — the diversity the province head needs to not
        # latch onto one exact rendering of each of the 31 CJK glyphs
        # (round-2 finding: pro_loss plateaued at 0.92 while same-sized
        # latin slots converged)
        self.diversity = float(diversity)

    # ---- string sampling ----

    def sample_classes(self, style: PlateStyle):
        rng = self.rng
        pro = int(rng.integers(style.pro_lo, style.pro_hi))
        alp = int(rng.integers(style.alp_lo, len(ALP_NAMES)))
        n_ads = style.n_chars - 2
        ads = [int(rng.integers(0, style.ads_hi)) for _ in range(n_ads)]
        while len(ads) < 6:
            ads.append(ADS_PAD)
        return pro, alp, ads[:6]

    # ---- canvas drawing ----

    def _canvas(self, style: PlateStyle):
        bg, fg = STYLE_COLORS[style.name]
        w, h = 226 if style.n_chars == 7 else 250, 70
        img = np.zeros((h, w, 3), np.uint8)
        img[:] = bg
        if style.name.startswith("green"):
            # new-energy gradient: white -> green left to right
            grad = np.linspace(0.35, 1.0, w, dtype=np.float32)[None, :, None]
            white = np.array((255, 255, 255), np.float32)
            img = (white * (1 - grad) + np.asarray(bg, np.float32) * grad
                   ).astype(np.uint8)[None].repeat(h, 0)[0]
            img = np.broadcast_to(img, (h, w, 3)).copy()
        return img, np.asarray(fg, np.uint8)

    def _weather_glyph(self, mask: np.ndarray, ch: str, is_cjk: bool,
                       cw: int) -> np.ndarray:
        """Per-instance glyph variation (active when self.diversity > 0)."""
        import cv2

        rng = self.rng
        d = self.diversity
        if is_cjk and ch in glyph_lib.GLYPH_CHARS and rng.random() < 0.8 * d:
            # re-render the vector strokes at a jittered width instead of
            # reusing the cached canonical bitmap
            t = float(rng.uniform(0.065, 0.125))
            mask = glyph_lib.render_glyph(ch, cw, 70, thickness=t)
        r = rng.random()
        if r < 0.2 * d:
            mask = cv2.erode(mask, np.ones((2, 2), np.uint8))
        elif r < 0.4 * d:
            mask = cv2.dilate(mask, np.ones((2, 2), np.uint8))
        if rng.random() < 0.25 * d:  # cutout: bolt head / dirt patch
            h, w = mask.shape
            pw = int(rng.integers(2, max(3, w // 3)))
            ph = int(rng.integers(2, max(3, h // 4)))
            x0 = int(rng.integers(0, w - pw + 1))
            y0 = int(rng.integers(0, h - ph + 1))
            mask = mask.copy()
            mask[y0:y0 + ph, x0:x0 + pw] = 0
        if rng.random() < 0.4 * d:  # slight in-plane rotation
            h, w = mask.shape
            ang = float(rng.uniform(-5, 5))
            m = cv2.getRotationMatrix2D((w / 2, h / 2), ang, 1.0)
            mask = cv2.warpAffine(mask, m, (w, h))
        return mask

    def draw_plate(self, style: PlateStyle, pro: int, alp: int, ads: List[int]):
        img, fg = self._canvas(style)
        h, w = img.shape[:2]
        chars = ([PRO_NAMES[pro], ALP_NAMES[alp]]
                 + [ADS_NAMES[a] for a in ads[: style.n_chars - 2]])
        n = len(chars)
        cw, gap = 23, 6
        total = n * cw + (n - 1) * gap + 11  # extra separator gap after alp
        x = (w - total) // 2
        for i, ch in enumerate(chars):
            is_cjk = i == 0 or ch in ("警", "学")
            mask = (self.glyphs.cjk_glyph(ch, cw) if is_cjk
                    else self.glyphs.latin_glyph(ch, cw))
            if self.diversity > 0:
                mask = self._weather_glyph(mask, ch, is_cjk, cw)
            m = mask.astype(np.float32)[..., None] / 255.0
            img[0:70, x:x + cw] = (img[0:70, x:x + cw] * (1 - m)
                                   + fg * m).astype(np.uint8)
            x += cw + gap + (11 if i == 1 else 0)
        return img

    # ---- distortions with corner tracking (generate/utils.py) ----

    def _persp(self, img, corners, pts1, pts2, out_size):
        import cv2

        m = cv2.getPerspectiveTransform(pts1, pts2)
        dst = cv2.warpPerspective(img, m, out_size)
        c = cv2.perspectiveTransform(corners.reshape(-1, 1, 2).astype(np.float32),
                                     m).reshape(-1, 2)
        return dst, c

    def skew(self, img, corners, max_angle=30):
        """Horizontal shear-like perspective (utils.rot)."""
        h, w = img.shape[:2]
        angle = _rint(self.rng, 2 * max_angle) - max_angle
        out_w = w + int(h * math.cos(max_angle / 180 * math.pi))
        interval = abs(int(math.sin(angle / 180 * math.pi) * h))
        pts1 = np.float32([[0, 0], [0, h], [w, 0], [w, h]])
        if angle > 0:
            pts2 = np.float32([[interval, 0], [0, h], [out_w, 0],
                               [out_w - interval, h]])
        else:
            pts2 = np.float32([[0, 0], [interval, h], [out_w - interval, 0],
                               [out_w, h]])
        return self._persp(img, corners, pts1, pts2, (out_w, h))

    def jitter_perspective(self, img, corners, factor=10):
        """Random 4-point perspective (utils.rotRandrom)."""
        h, w = img.shape[:2]
        r = lambda: _rint(self.rng, factor)
        pts1 = np.float32([[0, 0], [0, h], [w, 0], [w, h]])
        pts2 = np.float32([[r(), r()], [r(), h - r()], [w - r(), r()],
                           [w - r(), h - r()]])
        return self._persp(img, corners, pts1, pts2, (w, h))

    def color_jitter(self, img):
        """HSV multiplicative jitter (utils.tfactor)."""
        import cv2

        hsv = cv2.cvtColor(img, cv2.COLOR_BGR2HSV).astype(np.float32)
        hsv[:, :, 0] *= 0.8 + self.rng.random() * 0.2
        hsv[:, :, 1] *= 0.3 + self.rng.random() * 0.7
        hsv[:, :, 2] *= 0.2 + self.rng.random() * 0.8
        return cv2.cvtColor(np.clip(hsv, 0, 255).astype(np.uint8),
                            cv2.COLOR_HSV2BGR)

    def composite_background(self, img, mask):
        """Fill the black (warped-out) region with environment texture
        (utils.random_envirment). Uses an env image if provided, else
        procedural noise texture."""
        import cv2

        h, w = img.shape[:2]
        if self.env_images:
            env = cv2.imread(self.env_images[_rint(self.rng, len(self.env_images))])
            env = cv2.resize(env, (w, h))
        else:
            base = self.rng.integers(0, 255, 3)
            env = np.clip(
                base[None, None, :]
                + self.rng.normal(0, 30, (h, w, 3)), 0, 255).astype(np.uint8)
            env = cv2.GaussianBlur(env, (0, 0), 3)
        out = img.copy()
        bg = mask == 0
        out[bg] = env[bg]
        return out

    def blur_and_noise(self, img):
        import cv2

        level = 1 + _rint(self.rng, 4)
        if self.diversity > 0:
            # vary capture sharpness: the fixed always-blurred regime of the
            # reference generator (kernel 3-9 at canonical 272px) leaves the
            # 23px-wide CJK glyph with ~2px strokes unreadable after the
            # paste downscale; keep heavy blur as a mode, not a certainty
            r = self.rng.random()
            level = 0 if r < 0.3 * self.diversity else (
                1 + _rint(self.rng, 2) if r < 0.8 else 1 + _rint(self.rng, 4))
        if level:
            img = cv2.blur(img, (level * 2 + 1, level * 2 + 1))
        noise = self.rng.normal(0, 1 + _rint(self.rng, 6), img.shape)
        span = noise.max() - noise.min()
        if span > 0:
            noise = (noise - noise.min()) / span
        headroom = 255 - int(img.max())
        return (img + (noise * headroom).astype(np.uint8)).astype(np.uint8)

    # ---- full pipeline ----

    def pick_style(self) -> str:
        t = self.rng.random()
        acc = 0.0
        for name, p in STYLE_PROBS:
            acc += p
            if t <= acc:
                return name
        return STYLE_PROBS[-1][0]

    def generate(self, style_name: Optional[str] = None
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        import cv2

        style = STYLES[style_name or self.pick_style()]
        pro, alp, ads = self.sample_classes(style)
        plate = self.draw_plate(style, pro, alp, ads)
        h, w = plate.shape[:2]
        corners = np.float32([[0, 0], [0, h], [w, h], [w, 0]])  # TL BL BR TR
        mask = np.full((h, w), 255, np.uint8)

        plate, corners = self.skew(plate, corners, max_angle=30)
        plate, corners = self.jitter_perspective(plate, corners, factor=10)
        # the plate region mask is exactly the transformed corner quad
        mask = np.zeros(plate.shape[:2], np.uint8)
        cv2.fillConvexPoly(mask, corners.astype(np.int32), 255)

        plate = self.color_jitter(plate)
        plate = self.composite_background(plate, mask)
        plate = self.blur_and_noise(plate)

        # resize to canonical SIZE
        sw, sh = self.SIZE
        rw, rh = sw / plate.shape[1], sh / plate.shape[0]
        plate = cv2.resize(plate, (sw, sh), interpolation=cv2.INTER_LINEAR)
        mask = cv2.resize(mask, (sw, sh), interpolation=cv2.INTER_NEAREST)
        corners = corners * np.float32([rw, rh])

        xs, ys = corners[:, 0], corners[:, 1]
        box = np.float32([xs.min(), ys.min(), xs.max(), ys.max()])
        cls = np.float32([pro, alp] + ads)
        label = np.concatenate([cls, box, corners.reshape(-1)])[None, :]
        return plate, label.astype(np.float32), mask


def warp_into_image(img: np.ndarray, labels: np.ndarray,
                    gen: PlateGenerator, rng=None) -> Tuple[np.ndarray, np.ndarray]:
    """Replace up to `len(labels)` labeled plates with fresh synthetic plates
    warped into their corner quads; updates the class labels
    (generate/generate.py:536 generate_one). labels: (n, 20) pixel coords."""
    import cv2

    rng = rng or gen.rng
    if len(labels) == 0:
        return img, labels
    num = int(rng.integers(0, len(labels) + 1))
    for idx in range(num):
        corner = labels[idx, 12:20]
        quad = corner.reshape(4, 2)
        x_min, y_min = quad.min(0).astype(int)
        x_max, y_max = quad.max(0).astype(int)
        if x_max - x_min < 8 or y_max - y_min < 4:
            continue
        dst_pts = (quad - [x_min, y_min]).astype(np.float32)
        background = img[y_min:y_max, x_min:x_max]

        plate, p_label, mask = gen.generate()
        src_pts = p_label[0, 12:20].reshape(4, 2).astype(np.float32)
        size = (background.shape[1], background.shape[0])
        m = cv2.getPerspectiveTransform(src_pts, dst_pts)
        warped = cv2.warpPerspective(plate, m, size)
        wmask = cv2.warpPerspective(mask, m, size)
        region = background.copy()
        sel = wmask > 0
        region[sel] = warped[sel]
        img[y_min:y_max, x_min:x_max] = region
        labels[idx, :8] = p_label[0, :8]
    return img, labels


def paste_plates(img: np.ndarray, labels: np.ndarray, gen: PlateGenerator,
                 rng=None, min_num=0, max_num=3, ratio_min=0.1, ratio_max=0.4,
                 masked=True):
    """Paste fresh plates into non-overlapping regions, appending labels
    (datasets.py:441 get_paste_generate). labels: (n, 20) pixel coords.

    masked=True blends only the plate quad (feathered) so the scene shows
    through around it — the reference pastes the full rectangular patch, but
    its patch background is a real env photo; ours is procedural, and a hard
    rectangular seam would teach the detector 'noise rectangle == plate'.
    """
    import cv2

    rng = rng or gen.rng
    img_h, img_w = img.shape[:2]
    num = int(rng.integers(min_num, max_num + 1))
    for _ in range(num):
        plate, label, mask = gen.generate()
        ph, pw = plate.shape[:2]
        ratio = rng.uniform(ratio_min, ratio_max)
        w = max(int(img_w * ratio), 8)
        h = max(int(w * ph / pw), 4)
        if h >= img_h or w >= img_w:
            continue
        plate = cv2.resize(plate, (w, h), interpolation=cv2.INTER_LINEAR)
        mask = cv2.resize(mask, (w, h), interpolation=cv2.INTER_LINEAR)
        scale = np.float32([w / pw, h / ph] * 6)
        label = label.copy()
        label[0, 8:20] *= scale

        for _try in range(10):
            lt_x = int(rng.uniform(0, img_w - w))
            lt_y = int(rng.uniform(0, img_h - h))
            cand = np.float32([lt_x, lt_y, lt_x + w, lt_y + h])
            overlap = False
            for l in labels:
                b = l[8:12]
                ix = max(0, min(b[2], cand[2]) - max(b[0], cand[0]))
                iy = max(0, min(b[3], cand[3]) - max(b[1], cand[1]))
                if ix * iy > 0:
                    overlap = True
                    break
            if not overlap:
                roi = img[lt_y:lt_y + h, lt_x:lt_x + w]
                if masked:
                    a = cv2.GaussianBlur(mask, (0, 0), 1.0)
                    a = a.astype(np.float32)[..., None] / 255.0
                    blended = roi.astype(np.float32) * (1 - a) \
                        + plate.astype(np.float32) * a
                    img[lt_y:lt_y + h, lt_x:lt_x + w] = blended.astype(np.uint8)
                else:
                    img[lt_y:lt_y + h, lt_x:lt_x + w] = plate
                shifted = label.copy()
                shifted[0, 8:20] += np.float32([lt_x, lt_y] * 6)
                shifted[0, 8:20] = shifted[0, 8:20].clip(
                    0, max(img_h, img_w))
                labels = (np.concatenate([labels, shifted], 0)
                          if len(labels) else shifted)
                break
    return img, labels
