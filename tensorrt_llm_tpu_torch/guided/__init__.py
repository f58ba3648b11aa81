from .grammar_matcher import (GrammarMatcher, MatcherFactory,  # noqa: F401
                              TokenTable, json_object_regex,
                              json_value_regex, schema_to_regex)
from .guided_decoder import GuidedDecoder  # noqa: F401
