"""The benchmark's plain reference: GF(2^8) arithmetic, the codes' generators
and the stripes' true contents, in numpy and plain PyTorch.  It imports
nothing of the program under test."""
