"""The benchmark's plain reference: float64 NumPy, written from the
formulas of the nucleosome-calling chain and independent of the program.

It imports nothing of the program under test and takes nothing the
program made. From the raw inputs the benchmark hands to both sides (raw
fragment lefts and template lengths, the genome's base codes, the Tn5 PWM
probabilities, the V-plot template and the stated parameters) it works out
again what the program derives: the adjusted fragments, the peak tiles,
the fragment-size histogram and mixture fit, each window's raster, the
occupancy log-likelihood surface and its picks, the PWM log bias, the bias
matrix, the template cross-correlation scores and the u16 step of each
window's norm.

``chain`` holds the per-window arithmetic, ``fit`` the histogram and the
mixture, ``tiles`` the peak merge and tiling, ``inputs`` the template and
PWM the benchmark hands to both sides.
"""
