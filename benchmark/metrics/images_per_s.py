"""images_per_s: images whose detections reached host memory, over the
window's seconds (every batch of the window, closed loop)."""


def read(rec):
    return rec["images"] / rec["window_s"]
