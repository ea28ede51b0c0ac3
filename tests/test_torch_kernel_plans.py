"""Launch plans and argument structs of the K1 decode and the K4 backward,
on the CPU (no card, no nvcc).

K1 (`ops/kernels/ar_decode.py::plan`) splits one stream's decode over a
cluster of CL blocks; the kernel trusts the plan for which heads and rows a
block owns, so the split must cover every head and every row of each
product exactly once, for every cluster size the plan picks, and fit the
shared memory of a block.  The K4 backward (`fused_attention.py::bwd_plan`)
assigns (head, key tile) pairs to blocks; each must be computed exactly
once.  Both kernels take one struct whose field offsets the C side asserts
(`ARG_AT`); here those offsets are held to the wrapper's layout, so a
swapped pair of fields fails without a build.
"""

import ctypes
import re
from collections import Counter

import pytest

from latent_diffusion_speech_tpu_torch.models.lm.roformer import StackConfig
from latent_diffusion_speech_tpu_torch.ops.kernels import ar_decode as k1
from latent_diffusion_speech_tpu_torch.ops.kernels import build
from latent_diffusion_speech_tpu_torch.ops.kernels import fused_attention as k4

V = 4099  # the flagship vocabulary: 4096 k-means units + BOS, EOS, PAD


def _c_offsets(source: str) -> dict:
    text = (build.CSRC_DIR / source).read_text()
    return {name: int(at) for name, at in re.findall(r"^ARG_AT\((\w+), (\d+)\);", text, re.M)}


@pytest.mark.parametrize("C,H,CL", [(256, 8, 8), (128, 4, 4), (192, 6, 2), (192, 3, 1), (256, 4, 4)])
@pytest.mark.parametrize("elem", [2, 4])
def test_k1_plan_covers_every_head_and_row_once(C, H, CL, elem):
    """Every head, every query/key/value channel, every row of the C-row
    products and of ff_in, and every vocabulary row belongs to exactly one
    block of the cluster; CL is the largest of 8, 4, 2, 1 that divides H."""
    I = 512
    p = k1.plan(C, H, I, V, 48, 430, 1, elem)
    assert p.CL == CL and p.nh * CL == H and p.D == C // H
    seen = {key: Counter() for key in ("heads", "qkv", "C", "I", "V")}
    for rank in range(p.CL):
        for key, rows in p.rows(rank, C, I, V).items():
            seen[key].update(rows)
    for key, n in (("heads", H), ("qkv", C), ("C", C), ("I", I), ("V", V)):
        assert sorted(seen[key]) == list(range(n)), key
        assert set(seen[key].values()) == {1}, key


@pytest.mark.parametrize("C,H", [(256, 8), (128, 4), (192, 6)])
@pytest.mark.parametrize("N", [430, 1024])
@pytest.mark.parametrize("elem", [2, 4])
def test_k1_plan_accepts_every_geometry_and_fits_shared_memory(C, H, N, elem):
    """The geometries the earlier one-block kernel took still plan, at the
    serve default max_length = 1024 and the encoder's longest input (its
    max_position_embeddings), within the 227 KB a block may use."""
    L = StackConfig().max_position_embeddings
    p = k1.plan(C, H, 512, V, L, N, 1, elem)
    assert p.smem_bytes <= 227 * 1024
    assert p.stages >= 2 and p.chunk >= 512 * elem and p.chunk % 16 == 0


def test_k1_flagship_bf16_keeps_its_kv_cache_in_shared_memory():
    """At the flagship width in bf16 the block's KV cache slice (one head,
    N = 1024) stays in shared memory, beside a weight ring of two or more
    slots; at N = 430 the encoder K/V and a deeper ring fit too."""
    p = k1.plan(256, 8, 512, V, 48, 1024, 1, 2)
    assert p.CL == 8 and p.kv_smem and p.stages >= 2
    p = k1.plan(256, 8, 512, V, 48, 430, 1, 2)
    assert p.kv_smem and p.ckv_smem and p.stages >= 4
    assert p.smem_bytes <= 227 * 1024


@pytest.mark.parametrize("elem,N,L,shared", [
    (2, 430, 48, True),    # chip_smoke.py's bf16 decodes at N=430
    (2, 1024, 48, False),  # the serve default max_length in bf16
    (4, 430, 24, False),   # the f32 flagship-width cuda tests
    (4, 1024, 24, True),   # the f32 N=1024 cuda test (its KV cache in device memory)
    (4, 200, 48, True),    # the f32 placement cuda test
])
def test_k1_plan_places_the_encoder_kv_in_both_memories(elem, N, L, shared):
    """The encoder K/V goes to shared memory only where it fits beside the
    KV cache and a four-slot ring; the decodes the cuda tests and
    chip_smoke.py run reach both placements.  encoder_kv_smem=False keeps
    it in device memory at any size, the rest of the plan rebuilt to fit."""
    p = k1.plan(256, 8, 512, V, L, N, 1, elem)
    assert p.ckv_smem == shared and p.smem_bytes <= 227 * 1024
    q = k1.plan(256, 8, 512, V, L, N, 1, elem, encoder_kv_smem=False)
    assert not q.ckv_smem and q.kv_smem == p.kv_smem and q.smem_bytes <= 227 * 1024
    assert q.smem_bytes == k1._smem_bytes(256, 8, 512, V, L, N, 1, 8, elem, q.kv_smem, False, q.stages, q.chunk)


def test_k1_args_fields_sit_where_the_c_struct_asserts_them():
    """csrc/ar_decode.cu asserts each ArDecodeArgs field's offset and the
    struct's size; the ctypes `_Args` must agree field by field."""
    c_offsets = _c_offsets("ar_decode.cu")
    assert c_offsets == {name: getattr(k1._Args, name).offset for name, _ in k1._Args._fields_}
    text = (build.CSRC_DIR / "ar_decode.cu").read_text()
    assert f"static_assert(sizeof(ArDecodeArgs) == {ctypes.sizeof(k1._Args)}," in text


def test_k4_bwd_args_fields_sit_where_the_c_struct_asserts_them():
    """csrc/attention_bwd.cu asserts each BwdArgs field's offset; the
    wrapper's `BWD_ARGS` format and `BWD_ARG_NAMES` must agree (the 15
    strides are one array, `s`, on the C side)."""
    offsets, at = {}, 0
    for count, code in re.findall(r"(\d*)([a-zA-Z])", k4.BWD_ARGS.format.lstrip("<")):
        for _ in range(int(count or 1)):
            if code != "x":
                offsets[len(offsets)] = at
            at += 1 if code == "x" else {"q": 8, "i": 4, "f": 4}[code]
    by_name = dict(zip(k4.BWD_ARG_NAMES, offsets.values(), strict=True))
    c_offsets = _c_offsets("attention_bwd.cu")
    assert c_offsets.pop("s") == by_name["sqb"]
    strides = {f"s{x}{a}" for x in ("q", "k", "v", "o", "do") for a in "bth"}
    assert c_offsets == {n: o for n, o in by_name.items() if n not in strides}
    assert [by_name[n] - by_name["sqb"] for n in k4.BWD_ARG_NAMES if n in strides] == list(range(0, 120, 8))
    text = (build.CSRC_DIR / "attention_bwd.cu").read_text()
    assert f"static_assert(sizeof(BwdArgs) == {k4.BWD_ARGS.size}," in text


@pytest.mark.parametrize("B,T,H,D", [(48, 88, 8, 32), (48, 44, 8, 48), (48, 22, 8, 64), (48, 11, 8, 64),
                                     (4, 13, 8, 32), (4, 130, 8, 48), (3, 16, 5, 32), (1, 33, 3, 64)])
def test_k4_bwd_plan_covers_every_head_and_key_tile_once(B, T, H, D):
    """Each (batch * head, key tile) pair is computed by exactly one block;
    heads share a block only with 16-key tiles (T <= 16, a warp a head);
    the dq partials and counters exist exactly when a head has several key
    tiles."""
    p = k4.bwd_plan(B, T, H, D)
    pairs = Counter(pair for _, owned in k4.bwd_blocks(p, B, H) for pair in owned)
    assert sorted(pairs) == [(bh, kt) for bh in range(B * H) for kt in range(p["n_kt"])]
    assert set(pairs.values()) == {1}
    assert (p["tile"] == 16) == (T <= 16) and p["heads"] == (4 if T <= 16 else 1)
    assert p["n_kt"] * p["tile"] >= T > (p["n_kt"] - 1) * p["tile"]
    several = p["n_kt"] > 1
    assert p["dq_part"] == (B * H * p["n_kt"] * T * D if several else 0)
    assert p["counters"] == (B * H if several else 0)



@pytest.mark.parametrize("B,T,H,D", [(48, 11, 8, 64), (4, 13, 8, 32), (3, 16, 5, 32), (2, 1, 3, 48)])
def test_k4_bwd_plan_with_32_key_tiles_covers_every_head_once(B, T, H, D):
    """tile=32 where T <= 16 (the yardstick for the 16-key path): one key
    tile, a head a block, every head once, no dq scratch."""
    p = k4.bwd_plan(B, T, H, D, tile=32)
    pairs = Counter(pair for _, owned in k4.bwd_blocks(p, B, H) for pair in owned)
    assert sorted(pairs) == [(bh, 0) for bh in range(B * H)] and set(pairs.values()) == {1}
    assert p["tile"] == 32 and p["heads"] == 1 and p["grid"] == (1, B * H)
    assert p["dq_part"] == 0 and p["counters"] == 0


@pytest.mark.parametrize("T,tile", [(17, 16), (88, 16), (11, 8), (40, 64)])
def test_k4_bwd_plan_rejects_tiles_the_kernel_has_not(T, tile):
    """The kernel has 16-key tiles for T <= 16 and 32-key tiles for any T."""
    with pytest.raises(ValueError):
        k4.bwd_plan(48, T, 8, 32, tile=tile)
