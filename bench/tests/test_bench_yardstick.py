"""The yardstick's counts at the four cells' shapes (phi3-medium in its
sliding window), against values worked by hand (each sum written out in
its comment)."""

from __future__ import annotations

from bench.harness.yardstick import (HBM_BW, PEAK_FLOPS_BF16, Dims, attention_pairs, bound_s,
                                     decode_step_work, decode_work, flash_work, prefill_work,
                                     swiglu_work)

PHI3 = Dims(layers=40, d=5120, hq=40, hkv=10, dh=128, f=17920, vocab=32064, window=2047)
MIXTRAL = Dims(layers=13, d=6144, hq=48, hkv=8, dh=128, f=16384, vocab=32768, experts=8,
               top_k=2)


def test_peaks_are_the_h100_data_sheet():
    assert (PEAK_FLOPS_BF16, HBM_BW) == (989e12, 3.35e12)
    assert bound_s(3.35e12, 0) == 1.0 and bound_s(0, 989e12) == 1.0


def test_causal_pairs():
    # 4096 queries, query i sees i + 1 keys: 4096 * 4097 / 2
    assert attention_pairs(4096, 4096) == 8_390_656
    assert attention_pairs(1, 2049) == 2049  # one decode query over the cache
    assert attention_pairs(4096, 4096, causal=False) == 4096 * 4096


def test_windowed_pairs():
    # window 2047: queries 0..2046 see 1..2047 keys (2047 x 2048 / 2 = 2,096,128),
    # the other 2049 see 2047 each (4,194,303)
    assert attention_pairs(4096, 4096, window=2047) == 6_290_431
    assert attention_pairs(4096, 4096, window=4096) == 8_390_656  # no narrower than causal
    assert attention_pairs(1, 2049, window=2047) == 2047  # one decode query


def test_swiglu_work_phi3_prefill_and_decode():
    # bytes 2 (2 x 16384 x 5120 + 3 x 5120 x 17920) = 2 (167,772,160 + 275,251,200)
    # operations 6 x 16384 x 5120 x 17920
    assert swiglu_work(16384, 5120, 17920) == (886_046_720, 9_019_431_321_600)
    # T 48: 2 (2 x 48 x 5120 + 275,251,200); 6 x 48 x 91,750,400
    assert swiglu_work(48, 5120, 17920) == (551_485_440, 26_424_115_200)


def test_flash_work_prefill_cells():
    # phi3: 2 x 4 x 128 (2 x 4096 x 40 + 2 x 4096 x 10) bytes; 4 x 128 x 8,390,656 x 4 x 40
    assert flash_work(4, 40, 10, 4096, 4096, 128) == (419_430_400, 687_362_539_520)
    # in its 2,047-key window: 4 x 128 x 6,290,431 x 4 x 40
    assert flash_work(4, 40, 10, 4096, 4096, 128, window=2047) == (419_430_400,
                                                                  515_312_107_520)
    # mixtral: 1024 (2 x 4096 x 48 + 2 x 4096 x 8); 512 x 8,390,656 x 4 x 48
    assert flash_work(4, 48, 8, 4096, 4096, 128) == (469_762_048, 824_835_047_424)


def test_decode_work_decode_cells():
    # phi3 B 48 over 2,049 rows: 2 (2 x 48 x 40 x 128 + 2 x 48 x 2049 x 10 x 128)
    assert decode_work(48, 40, 10, 128, 2049) == (504_545_280, 2_014_248_960)
    # mixtral B 16: 2 (2 x 16 x 48 x 128 + 2 x 16 x 2049 x 8 x 128); 4 x 128 x 2049 x 16 x 48
    assert decode_work(16, 48, 8, 128, 2049) == (134_676_480, 805_699_584)


def test_phi3_prefill_call():
    # per layer: projections 16384 x 2 x 5120 x 12800 = 2,147,483,648,000
    #   + windowed attention 515,312,107,520 + SwiGLU 9,019,431,321,600 = 11,682,227,077,120;
    # x 40 + the last positions' logits 2 x 4 x 5120 x 32064 = 1,313,341,440
    # bytes: 40 x (131,092,480 attention + 550,502,400 SwiGLU) weights + 328,345,600 head
    #   + 167,903,232 embedding rows and tokens + 3,355,443,200 cache + 256,512 logits
    assert prefill_work(PHI3, 4, 4096) == (31_115_743_744, 467_290_396_426_240)


def test_mixtral_prefill_call_counts_kept_pairs():
    # every pair kept: per layer 16384 x 2 x 6144 x 14336 + 824,835,047,424 attention
    #   + router 2 x 16384 x 6144 x 8 + 32768 pairs x 6 x 6144 x 16384
    nbytes, flops = prefill_work(MIXTRAL, 4, 4096, kept_pairs=13 * 32768)
    per_layer = (16384 * 2 * 6144 * 14336 + 824_835_047_424 + 2 * 16384 * 6144 * 8
                 + 32768 * 6 * 6144 * 16384)
    assert flops == 13 * per_layer + 2 * 4 * 6144 * 32768 == 305_551_959_392_256
    assert nbytes == 66_582_384_640
    # a dropped pair is 6 x 6144 x 16384 operations fewer
    assert prefill_work(MIXTRAL, 4, 4096, kept_pairs=13 * 32768 - 1)[1] == flops - 603_979_776


def test_decode_steps():
    # phi3 B 48 past 2,049 rows, its window's 2,047 read:
    #   40 x (48 x 131,072,000 + 4 x 128 x 2047 x 48 x 40 + 48 x 6 x 91,750,400)
    #   + 2 x 48 x 5120 x 32064; two rows fewer a layer than 2,049 would read,
    #   2 x 2 x 48 x 10 x 128 x 2 x 40 = 19,660,800 bytes
    assert decode_step_work(PHI3, 48, 2049) == (47_728_370_048, 1_404_874_260_480)
    # mixtral B 16, every expert read, 32 pairs a layer kept
    assert decode_step_work(MIXTRAL, 16, 2049, kept_pairs=13 * 32,
                            experts_read=13 * 8) == (67_256_029_312, 304_834_019_328)
    # its bound: 67.26 GB at 3.35 TB/s, 20.08 ms
    assert abs(bound_s(67_256_029_312, 304_834_019_328) - 0.0200764) < 1e-6
