"""SQPV: the sliding constant-Q phase vocoder (counterpart of flan_tpu/sqpv)."""
