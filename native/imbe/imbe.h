/* IMBE-architecture voice codec for P25 Phase 1 voice frames.
 *
 * Native host library filling the op25 `repeater.vocoder` role
 * (reference logging_receiver.py:253, file_to_wav.py:92): each 144-bit
 * P25 voice codeword decodes to 160 samples of 8 kHz PCM (20 ms).
 *
 * Implements the IMBE 7200x4400 channel structure per the published
 * frame architecture: eight information vectors u0..u7 — u0..u3 12 bits
 * each protected by Golay(23,12), u4..u6 11 bits each protected by
 * Hamming(15,11), u7 7 bits unprotected — with the u1..u6 codewords
 * XOR-scrambled by the 16-bit PN generator seeded from u0
 * (pr' = 173*pr + 13849 mod 2^16).
 *
 * Parameter layer status (see imbe.cc header for the full layout):
 * EXACT per the published model — w0 = 4*pi/(b0 + 39.5) with 8-bit b0;
 * L = floor(0.9254*floor(pi/w0 + 0.25)) harmonics clamped to [9, 56];
 * K = min(12, (L+2)/3) voicing bands of 3 harmonics; 6-bit gain;
 * 74-K amplitude bits; hierarchical quantization of log2-amplitude
 * prediction residuals (rho = 0.7 closed-loop prediction, 6 near-equal
 * blocks DCT'd, block DC terms re-DCT'd into the PRBA vector whose DC
 * folds into the gain); split MSB/LSB priority placement of b0 and the
 * gain (b0 MSBs open the frame in Golay-protected u0, its 2 LSBs and
 * the gain's 2 LSBs close it in unprotected u7).
 *
 * RECONSTRUCTED surfaces are exactly the four named tables in
 * imbe_tables.h (gain levels, PRBA allocation weights, higher-order
 * allocation weights, quantizer spans) — see the TABLE PROVENANCE
 * LEDGER there; nothing else in the codec diverges from the published
 * model description.  Consequence for off-air frames: correct
 * pitch/voicing/gain-scale structure with approximate spectral detail
 * until the Annex tables can be validated in.  Closed-loop (this
 * encoder <-> this decoder) the codec is bit-exact and FEC-corrects up
 * to 3 errors per Golay word and 1 per Hamming word; parameter frames
 * built directly from explicit (b0, voicing, gain, amps) round-trip
 * exactly for every b0 (tests/test_imbe.py).
 */
#ifndef RC_IMBE_H
#define RC_IMBE_H

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef struct imbe_decoder imbe_decoder_t;
typedef struct imbe_encoder imbe_encoder_t;

/* Model parameters of one 20 ms frame. */
typedef struct {
  int b0;           /* fundamental index, 0..207 */
  uint32_t voicing; /* band bits at positions 11..12-K, bit 11 = band 0
                     * (voiced=1); only the frame's K bands transmit */
  int gain;         /* 6-bit log2 gain index, level = 2^((gain-40)/4) */
  uint8_t amps[56]; /* quantized amplitude DCT coefficients in priority
                     * order: [0..4] = PRBA G1..G5, then higher-order
                     * block coefficients (L-1 used) */
} imbe_params_t;

/* ---- frame codec ---- */
/* bits: 144 entries of 0/1. Returns corrected bit-error count, or -1 if
 * u0's Golay failed (frame unusable). */
int imbe_unpack_frame(const uint8_t bits[144], imbe_params_t* p);
void imbe_pack_frame(const imbe_params_t* p, uint8_t bits[144]);

/* ---- FEC primitives (exposed for tests) ---- */
uint32_t imbe_golay23_encode(uint32_t data12);
int imbe_golay23_decode(uint32_t cw, uint32_t* data12); /* -> nerrs|-1 */
uint32_t imbe_hamming15_encode(uint32_t data11);
int imbe_hamming15_decode(uint32_t cw, uint32_t* data11);

/* ---- decoder (synthesis) ---- */
imbe_decoder_t* imbe_decoder_create(void);
void imbe_decoder_destroy(imbe_decoder_t* d);
/* 144 bits -> 160 PCM samples @8 kHz; returns corrected errors or -1. */
int imbe_decode(imbe_decoder_t* d, const uint8_t bits[144],
                int16_t pcm[160]);
int imbe_errors(const imbe_decoder_t* d); /* cumulative corrected bits */

/* ---- encoder (analysis; fixture generation + closed-loop tests) ---- */
imbe_encoder_t* imbe_encoder_create(void);
void imbe_encoder_destroy(imbe_encoder_t* e);
/* 160 PCM samples -> 144 bits. */
void imbe_encode(imbe_encoder_t* e, const int16_t pcm[160],
                 uint8_t bits[144]);
/* Encode explicit parameters (deterministic fixtures). */
void imbe_encode_params(const imbe_params_t* p, uint8_t bits[144]);

int imbe_harmonics_for_b0(int b0); /* L */
int imbe_bands_for_L(int L);       /* K = min(12, (L+2)/3) */
/* Amplitude bit allocation: fills q[0..N-1] (N = L-1 coefficients in
 * priority order: PRBA G1..G5 then higher-order block coefficients)
 * with the per-coefficient bit counts for the 74-K budget; returns N.
 * Deterministic water-filling on the imbe_tables.h weights. */
int imbe_coef_alloc(int L, int K, int q[55]);
/* 88-bit priority stream (u0..u7 info bits) for tests/diagnostics. */
void imbe_scan_params(const imbe_params_t* p, uint8_t info[88]);

#ifdef __cplusplus
}
#endif
#endif /* RC_IMBE_H */
