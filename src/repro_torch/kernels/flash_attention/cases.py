"""The flash-attention kernel's parity cases, (B, T, S, H, K, Dh, causal,
window, q_offset) each: ``chip_smoke.py`` and the card tests hold the
kernel to ``attention_ref`` on every one, in f32 and bf16, and the CPU
tests run ``tile_plan`` on each one's (T, S, causal, window, Dh,
q_offset).

The CPU tests' shapes; ragged T and S; GQA 2 and 3; Dh 16, 32, 48, 64 and
80; windows below, at and above T; Dh 256 (gemma-7b) causal, with GQA, a
window, ragged T and S. Then the bf16 kernel's tile edges (128-row q
tiles; kv tiles of 128 keys at Dh 80, 80 keys at Dh 256): T = S of 127,
129 and 255 (and 161 at Dh 256), window 1 and a window of one kv tile,
GQA 4 at Dh 256, non-causal S < T. Then the moe services' batches of
8 x 4,096 tokens: GQA 16/8 at Dh 64 (granite-moe-1b-a400m) and GQA 32/4
at Dh 128 (qwen3-moe-30b-a3b), 32 q tiles against 32 kv tiles each.
Last, the vlm and audio families: hubert-xlarge's non-causal MHA 16/16
at Dh 80, at T = S = 1500 (30 s of audio at 50 frames a second; every kv
tile of every q tile visited, the last one an edge tile of 92 keys) and
at the service's 4,096, and pixtral-12b's causal GQA 32/8 at Dh 128.
Then the per-rank program: yi-6b's heads on one rank of a model axis of
2, causal GQA 16/2 at Dh 128, at B 2 x T 4,096. Last, query offsets
(context parallelism: a rank's slice of a q chunk at its positions):
smollm-135m's 9 heads on a model axis of 2 at B 2 x T 4,096, 512 rows a
rank of each 1,024-row chunk, the first and the last slice against every
key; the keys cut at the slice's last position (what a causal slice can
see), offsets off the 128-row tiles, windows, Dh 256 and non-causal.
"""

PARITY = [(2, 128, 128, 4, 4, 64, True, 0, 0),
          (2, 128, 128, 8, 2, 64, True, 0, 0),
          (1, 256, 256, 4, 1, 32, False, 0, 0),
          (2, 64, 64, 4, 4, 128, True, 0, 0),
          (1, 512, 512, 16, 4, 64, True, 0, 0),
          (2, 128, 128, 6, 2, 80, True, 0, 0),
          (1, 256, 256, 4, 2, 32, True, 32, 0),
          (1, 256, 256, 4, 2, 32, True, 256, 0),
          (2, 100, 100, 6, 2, 80, True, 0, 0),
          (1, 333, 333, 6, 3, 80, True, 64, 0),
          (1, 200, 200, 4, 2, 64, True, 200, 0),
          (1, 200, 200, 4, 2, 80, True, 300, 0),
          (1, 200, 200, 4, 2, 16, True, 300, 0),
          (1, 130, 70, 4, 4, 48, False, 0, 0),
          (2, 1000, 1000, 32, 32, 80, True, 256, 0),
          (1, 300, 300, 16, 16, 256, True, 0, 0),
          (2, 128, 128, 8, 2, 256, True, 0, 0),
          (1, 333, 333, 4, 2, 256, True, 64, 0),
          (1, 130, 70, 4, 4, 256, False, 0, 0),
          # the bf16 kernel's tile edges
          (1, 127, 127, 4, 2, 80, True, 0, 0),
          (1, 129, 129, 4, 2, 80, True, 0, 0),
          (1, 255, 255, 4, 2, 80, True, 0, 0),
          (1, 127, 127, 4, 2, 256, True, 0, 0),
          (1, 129, 129, 4, 2, 256, True, 0, 0),
          (1, 255, 255, 4, 2, 256, True, 0, 0),
          (1, 300, 300, 4, 2, 80, True, 1, 0),
          (1, 300, 300, 4, 2, 256, True, 1, 0),
          (1, 300, 300, 4, 2, 80, True, 128, 0),
          (1, 300, 300, 4, 2, 256, True, 64, 0),
          (1, 200, 200, 16, 4, 256, True, 0, 0),
          (1, 255, 129, 4, 2, 80, False, 0, 0),
          (1, 255, 127, 8, 2, 256, False, 0, 0),
          (1, 161, 161, 4, 2, 256, True, 0, 0),
          (1, 300, 300, 4, 2, 256, True, 80, 0),
          # the moe services' batches
          (8, 4096, 4096, 16, 8, 64, True, 0, 0),
          (8, 4096, 4096, 32, 4, 128, True, 0, 0),
          # the vlm and audio families
          (2, 1500, 1500, 16, 16, 80, False, 0, 0),
          (1, 4096, 4096, 16, 16, 80, False, 0, 0),
          (1, 4096, 4096, 32, 8, 128, True, 0, 0),
          # one rank of yi-6b on a model axis of 2
          (2, 4096, 4096, 16, 2, 128, True, 0, 0),
          # query offsets: smollm-135m's rank slices on a model axis of 2
          (2, 512, 4096, 9, 3, 64, True, 0, 512),
          (2, 512, 4096, 9, 3, 64, True, 0, 3584),
          (1, 200, 300, 4, 2, 64, True, 0, 100),
          (1, 130, 1000, 4, 2, 80, True, 256, 700),
          (1, 300, 1000, 4, 2, 256, True, 64, 650),
          (1, 130, 300, 4, 4, 48, False, 0, 77),
          (1, 64, 161, 4, 2, 256, True, 0, 97)]
