# Copied verbatim from kyverno_tpu/engine/jmespath/errors.py.
"""JMESPath error types."""


class JMESPathError(ValueError):
    pass


class LexerError(JMESPathError):
    def __init__(self, position, token, message):
        super().__init__(f"Bad jmespath expression: {message} at position {position}: {token!r}")
        self.position = position
        self.token = token


class ParseError(JMESPathError):
    def __init__(self, position, token, message="syntax error"):
        super().__init__(f"{message} at position {position}: unexpected token {token!r}")
        self.position = position
        self.token = token


class IncompleteExpressionError(ParseError):
    def __init__(self, position, token):
        super().__init__(position, token, "incomplete expression")


class JMESPathTypeError(JMESPathError):
    def __init__(self, function_name, current_value, actual_type, expected_types):
        super().__init__(
            f"In function {function_name}(), invalid type for value: {current_value!r}, "
            f"expected one of: {expected_types}, received: {actual_type!r}"
        )
        self.function_name = function_name


class ArityError(JMESPathError):
    def __init__(self, function_name, expected, actual):
        super().__init__(
            f"Expected {expected} argument(s) for function {function_name}(), received {actual}"
        )


class UnknownFunctionError(JMESPathError):
    pass


class FunctionError(JMESPathError):
    """Raised by custom functions on invalid input (e.g. bad regex)."""
