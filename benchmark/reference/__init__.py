"""The benchmark's plain reference: the lcpc-2d commitment over Ligero and
Brakedown, in plain PyTorch, NumPy and Python integers.

It imports nothing of the program under test and takes nothing the program
made: the benchmark hands it the coefficients it generated itself, and the
program's outputs only to judge them.
"""
