"""The plain reference: the paper's models, loss, optimizers and int8 row
rule in plain PyTorch, f32, with TF32 off unless a caller asks for it.

It imports nothing of the program under test and takes nothing the program
made: it works the quotient–remainder split, the int8 rows and the
optimizer state out again from the benchmark's own inputs.
"""
