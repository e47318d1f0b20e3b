"""The plain reference the benchmark judges the program by. It imports
neither JAX nor the program, and takes nothing the program made."""
