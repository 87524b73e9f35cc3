"""Plate-string vocabularies and the dataset yaml (copy of
yololp_tpu/data/vocab.py).

npro=31 province glyphs, nalp=24 letters (no I/O), nads=37 characters
(letters + digits + 警/学 + 'O' used as the 8-slot padding class).
"""

from __future__ import annotations

PRO_NAMES = ['皖', '沪', '津', '渝', '冀', '晋', '蒙', '辽', '吉', '黑', '苏', '浙',
             '京', '闽', '赣', '鲁', '豫', '鄂', '湘', '粤', '桂', '琼', '川', '贵',
             '云', '藏', '陕', '甘', '青', '宁', '新']
ALP_NAMES = ['A', 'B', 'C', 'D', 'E', 'F', 'G', 'H', 'J', 'K', 'L', 'M', 'N', 'P',
             'Q', 'R', 'S', 'T', 'U', 'V', 'W', 'X', 'Y', 'Z']
ADS_NAMES = ['A', 'B', 'C', 'D', 'E', 'F', 'G', 'H', 'J', 'K', 'L', 'M', 'N', 'P',
             'Q', 'R', 'S', 'T', 'U', 'V', 'W', 'X', 'Y', 'Z', '0', '1', '2', '3',
             '4', '5', '6', '7', '8', '9', '警', '学', 'O']

NPRO = len(PRO_NAMES)   # 31
NALP = len(ALP_NAMES)   # 24
NADS = len(ADS_NAMES)   # 37
ADS_PAD_CLASS = 36      # 'O' pads the 8th slot of 7-char plates


def plate_string(pro_id: int, alp_id: int, ads_ids) -> str:
    """Decode the 8 predicted ids into a human-readable plate string."""
    s = PRO_NAMES[int(pro_id)] + ALP_NAMES[int(alp_id)]
    for a in ads_ids:
        s += ADS_NAMES[int(a)]
    return s


def load_dataset_yaml(path: str) -> dict:
    """Load a dataset yaml (train/val/test paths + vocab overrides)."""
    import yaml

    with open(path) as f:
        data = yaml.safe_load(f)
    data.setdefault("npro", NPRO)
    data.setdefault("nalp", NALP)
    data.setdefault("nads", NADS)
    data.setdefault("names", PRO_NAMES)
    data.setdefault("alps", ALP_NAMES)
    data.setdefault("ads", ADS_NAMES)
    return data
