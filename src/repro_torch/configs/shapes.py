"""The four assigned input shapes (a copy of ``repro/configs/shapes.py``)."""

from repro_torch.configs.base import InputShape

SHAPES = {
    "train_4k": InputShape("train_4k", seq_len=4096, global_batch=256,
                           mode="train"),
    "prefill_32k": InputShape("prefill_32k", seq_len=32768, global_batch=32,
                              mode="prefill"),
    "decode_32k": InputShape("decode_32k", seq_len=32768, global_batch=128,
                             mode="decode"),
    "long_500k": InputShape("long_500k", seq_len=524288, global_batch=1,
                            mode="decode"),
}


def get_shape(name: str) -> InputShape:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name}; have {sorted(SHAPES)}")
    return SHAPES[name]
