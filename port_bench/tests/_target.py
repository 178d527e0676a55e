"""A function for the call recorder's test to watch."""


def solve_like(H, k=1):
    return H
