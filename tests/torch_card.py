"""What the port's card tests share: the ``card`` fixture, ``bits``, and
K4's cases: ``ATTN_CASES``, the shapes it is held to its plain version
at, and the tolerances it is held within.

A test marked ``card`` takes the fixture, which gives the CUDA card or
skips the test without one; whether there is a card is decided here, when
a test asks, never while a module is imported.  On a card:

    PYTHONPATH=src python -m pytest -m card tests/test_torch_card_*.py \\
        tests/test_torch_decode_graph.py
"""
import pytest
import torch


@pytest.fixture(scope="session")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    # float32 products in full float32 on the card, as on the host
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def bits(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bits as integers, so that ``torch.equal`` tells -0 from 0
    and compares NaNs."""
    view = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
            torch.float64: torch.int64}
    return t.contiguous().view(view[t.dtype]) if t.dtype in view else t


#: (B, Hq, Hkv, Sq, Sk, D, dtype, causal, window, q_offset): recurrentgemma's
#: local attention at three prompt lengths (2500 does not tile); qwen3-14b's
#: GQA widths; a cache longer than the queries and a non-causal case, each
#: in both dtypes; the 2048-token prefills of olmoe-1b-7b, granite-moe-3b,
#: qwen1.5-4b, starcoder2-15b and llama3-405b; the served shapes whose keys
#: run to max_seq past the prompt; whisper-small's encoder, cross and
#: decoder self attention (224- and 4-token prompts); llama-3.2-vision's
#: cross and self attention; qwen1.5-4b's and olmoe's prefills whose keys
#: run 4 decode steps past the prompt; llama3-405b's whose keys run 16 past
#: it.  ``tests/test_torch_card_models.py`` checks that every shape its
#: served runs launch K4 at is one of these.
ATTN_CASES = [
    (1, 16, 1, 1024, 1024, 256, "bfloat16", True, 2048, 0),
    (1, 16, 1, 2500, 2500, 256, "bfloat16", True, 2048, 0),
    (1, 16, 1, 4096, 4096, 256, "bfloat16", True, 2048, 0),
    (1, 40, 8, 4096, 4096, 128, "bfloat16", True, None, 0),
    (2, 4, 2, 128, 384, 64, "float32", True, None, 256),
    (1, 8, 2, 1000, 1000, 128, "float32", False, None, 0),
    (2, 4, 2, 128, 384, 64, "bfloat16", True, None, 256),
    (1, 8, 2, 1000, 1000, 128, "bfloat16", False, None, 0),
    (1, 16, 16, 2048, 2048, 128, "bfloat16", True, None, 0),
    (1, 24, 8, 2048, 2048, 64, "bfloat16", True, None, 0),
    (1, 20, 20, 2048, 2048, 128, "bfloat16", True, None, 0),
    (1, 48, 4, 2048, 2048, 128, "bfloat16", True, None, 0),
    (1, 128, 8, 2048, 2048, 128, "bfloat16", True, None, 0),
    (1, 48, 4, 2048, 2064, 128, "bfloat16", True, None, 0),
    (1, 24, 8, 2048, 2112, 64, "bfloat16", True, None, 0),
    (1, 40, 8, 4096, 4224, 128, "bfloat16", True, None, 0),
    (4, 12, 12, 1500, 1500, 64, "bfloat16", False, None, 0),
    (4, 12, 12, 224, 1500, 64, "bfloat16", False, None, 0),
    (4, 12, 12, 224, 448, 64, "bfloat16", True, None, 0),
    (2, 64, 8, 2048, 1600, 128, "bfloat16", False, None, 0),
    (2, 64, 8, 2048, 2112, 128, "bfloat16", True, None, 0),
    (4, 12, 12, 4, 448, 64, "bfloat16", True, None, 0),
    (4, 12, 12, 4, 1500, 64, "bfloat16", False, None, 0),
    (1, 20, 20, 2048, 2052, 128, "bfloat16", True, None, 0),
    (1, 16, 16, 2048, 2052, 128, "bfloat16", True, None, 0),
    (1, 128, 8, 2048, 2064, 128, "bfloat16", True, None, 0),
]
#: the prompt lengths of ``launch.serve``'s own traffic at its defaults
#: (seed 0, 8 requests, max_seq 128)
LAUNCHER_PROMPTS = (6, 12, 20, 25, 26, 27)
# recurrentgemma-9b's keys are its prompt (window 2048), olmoe-1b-7b's run
# to max_seq
ATTN_CASES += [(1, 16, 1, s, s, 256, "bfloat16", True, 2048, 0)
               for s in LAUNCHER_PROMPTS]
ATTN_CASES += [(1, 16, 16, s, 128, 128, "bfloat16", True, None, 0)
               for s in LAUNCHER_PROMPTS]

#: atol = rtol against the plain version (the JAX package's kernel tests)
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
#: the largest error over the largest |want|; in bf16 2.5 roundings (2^-8)
#: of the largest output.  Keys left unmasked past Sk (zeros, logit 0)
#: scale a non-causal row by 1-2 % at these shapes, inside ATTN_TOL
ATTN_PEAK_TOL = {"float32": 2e-5, "bfloat16": 1e-2}


def within(out, want, tol: float) -> bool:
    out, want = out.float(), want.float()
    return bool(((out - want).abs() <= tol + tol * want.abs()).all())


def held_to_plain(out, want) -> bool:
    """K4's ``out`` within ``ATTN_TOL`` of the plain version's ``want``
    entry by entry, and its largest error within ``ATTN_PEAK_TOL`` of the
    largest ``|want|``."""
    dt = str(out.dtype).replace("torch.", "")
    err = (out.float() - want.float()).abs().max()
    return within(out, want, ATTN_TOL[dt]) and \
        float(err) <= ATTN_PEAK_TOL[dt] * float(want.float().abs().max())
