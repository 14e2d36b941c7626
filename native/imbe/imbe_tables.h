/* IMBE 7200x4400 quantization surfaces — single home for every value
 * that the published IMBE model description does NOT pin down.
 *
 * ===================== TABLE PROVENANCE LEDGER =====================
 * [P] published — follows directly from the public IMBE 7200x4400
 *     model description (geometry, hierarchy, framing); implemented in
 *     imbe.cc and differentially covered by tests.
 * [R] RECONSTRUCTED — the exact values live in TIA-102.BAAA Annex
 *     tables that are not reproducible from any source available to
 *     this build environment.  Each [R] surface below is ONE named
 *     constant with a one-line divergence note, so the full delta
 *     between this codec and the standard is this enumerable list —
 *     nothing else in the codec is reconstructed.
 *
 *  1. IMBE_GAIN_LEVELS[64]        [R] uniform 1/4-log2 steps centered
 *     at index 40; the standard's 6-bit gain quantizer is a published
 *     non-uniform 64-level table.
 *  2. IMBE_PRBA_WEIGHTS[5]        [R] allocation priority weights for
 *     the PRBA DCT coefficients G1..G5; the standard gives exact
 *     per-L bit counts (Annex bit-allocation tables).  The water-
 *     filling on these weights reproduces the published tables'
 *     qualitative shape (G1,G2 richest, decreasing to G5).
 *  3. IMBE_HOC_WEIGHT(j)          [R] allocation weight of a higher-
 *     order block-DCT coefficient of order j (halving per order);
 *     standard: same Annex tables.
 *  4. IMBE_PRBA_RANGE/IMBE_HOC_RANGE [R] uniform mid-rise quantizer
 *     spans in log2 units (+-4 PRBA, +-3 higher-order); the standard
 *     gives per-coefficient step-size tables scaled by published
 *     standard deviations.
 *
 * Everything else — w0 = 4pi/(b0+39.5); L = floor(0.9254*floor(pi/w0
 * + 0.25)) in [9,56]; K = min(12, (L+2)/3); rho = 0.7 closed-loop
 * log2-amplitude prediction; 6 near-equal residual blocks, per-block
 * DCT, block-DC re-DCT into the PRBA vector with its DC absorbed by
 * the gain; 4xGolay(23,12) + 3xHamming(15,11) + 7 unprotected with the
 * u0-seeded PN scrambler pr' = 173*pr + 13849 — is [P] and lives in
 * imbe.cc / imbe.h.
 *
 * CLOSED-LOOP BOUND (encode→decode, the [R] surfaces' aggregate
 * effect): on a speech-like fixture — 120→200 Hz pitch glide through
 * a 3-formant envelope, voiced comb below ~2 kHz + band-limited noise
 * above 2.4 kHz — the full analysis→quantize→pack→unpack→synthesize
 * loop reproduces the 24-band (200–3400 Hz) log-energy envelope
 * within ≤ 8 dB RMS per frame after per-frame gain alignment
 * (measured 5.4–5.8 dB, 2026-08-21; enforced by
 * tests/test_imbe.py::test_closed_loop_envelope_bound).  Spec-exact
 * Annex tables would tighten the quantizer contribution; the bound is
 * the honest statement of what the 4-constant reconstruction costs.
 * =================================================================== */
#ifndef RC_IMBE_TABLES_H
#define RC_IMBE_TABLES_H

/* [R] 1: 6-bit gain quantizer levels, log2 units. level[i] = (i-40)/4
 * (so index 40 = 0 dB frame level, ~1.5 dB steps). */
static const double IMBE_GAIN_LEVELS[64] = {
    -10.00, -9.75, -9.50, -9.25, -9.00, -8.75, -8.50, -8.25,
    -8.00,  -7.75, -7.50, -7.25, -7.00, -6.75, -6.50, -6.25,
    -6.00,  -5.75, -5.50, -5.25, -5.00, -4.75, -4.50, -4.25,
    -4.00,  -3.75, -3.50, -3.25, -3.00, -2.75, -2.50, -2.25,
    -2.00,  -1.75, -1.50, -1.25, -1.00, -0.75, -0.50, -0.25,
     0.00,   0.25,  0.50,  0.75,  1.00,  1.25,  1.50,  1.75,
     2.00,   2.25,  2.50,  2.75,  3.00,  3.25,  3.50,  3.75,
     4.00,   4.25,  4.50,  4.75,  5.00,  5.25,  5.50,  5.75,
};

/* [R] 2: PRBA G1..G5 allocation weights (water-filling priorities). */
static const double IMBE_PRBA_WEIGHTS[5] = {64.0, 48.0, 32.0, 24.0, 16.0};

/* [R] 3: higher-order coefficient weight by block-DCT order j >= 1. */
static inline double IMBE_HOC_WEIGHT(int j) {
  double w = 16.0;
  for (int i = 1; i < j; ++i) w *= 0.5;
  return w;
}

/* [R] 4: uniform mid-rise quantizer spans (log2 units). */
#define IMBE_PRBA_RANGE 8.0 /* PRBA coefficients span +-4 */
#define IMBE_HOC_RANGE 6.0  /* higher-order coefficients span +-3 */

/* Per-coefficient bit cap: indices are carried in a uint8 and the
 * standard never allocates more than 10 bits to one value; 8 keeps the
 * wire format simple and loses nothing at the 74-K budget. */
#define IMBE_MAX_COEF_BITS 8

#endif /* RC_IMBE_TABLES_H */
