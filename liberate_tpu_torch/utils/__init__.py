from .helpers import absmax_error, check_errors, random_complex_array

__all__ = ["absmax_error", "check_errors", "random_complex_array"]
