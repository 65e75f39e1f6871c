from .circuits import (
    eval_polynomial, linear_combination, fibonacci_chain, factorial_chain,
    power_chain, sum_chain,
)
