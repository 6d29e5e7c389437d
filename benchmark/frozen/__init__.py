"""Copies of the program's yardsticks, frozen at the commit the benchmark was written at."""
