"""Peak rates of the cards the benchmark runs on (NVIDIA's data sheet,
dense rates, at the card's full power limit; the run reports the limit
it found beside them). A card that is not listed has no peak, and its
roofline shares are not reported."""

PEAKS = {
    # H100 SXM: 3.35 TB/s of HBM3. INT32 counted as instructions a lane
    # (an IMAD is one): 132 multiprocessors x 64 INT32 lanes x 1.98 GHz
    # boost = 16.7e12 a second (the 67 TFLOP/s float32 rate counts an FMA
    # on each of 128 lanes as two)
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                              "int32_ops_per_s": 132 * 64 * 1.98e9},
}


def peak(ctx: dict) -> dict | None:
    """The peaks of the run's card, or None."""
    card = ctx.get("card") or ""
    name = card.split(",")[0].strip()
    return PEAKS.get(name)
