"""Self-contained English word segmentation (unigram Viterbi); the port of
``vse_tpu/post/wordseg.py``, with the same built-in corpus.

The reference re-splits concatenated OCR'd English via the `wordsegment`
package (reference backend/tools/reformat.py:31-33,117-123). That package
ships a Google-ngram corpus that is not vendored; this module implements
the same algorithm — maximize the product of unigram scores over a split,
with a Zipf-style penalty for out-of-vocabulary chunks — over a compact
built-in frequency list. (The JAX package's option of extending the list
from a user corpus file is not ported: nothing in the port sets it.)
"""

from __future__ import annotations

import math
from typing import Dict, List

# Compact frequency list: common English words with Zipf-ish pseudo-counts.
# Rank-ordered; count ~ C / rank.
_COMMON = """the of and to a in for is on that by this with i you it not or be
are from at as your all have new more an was we will home can us about if page
my has search free but our one other do no information time they site he up may
what which their news out use any there see only so his when contact here
business who web also now help get pm view online first am been would how were
me some these its like service than find date back top people had list name
just over state year day into email two health world next used go work last
most products music buy data make them should product system post her city
add policy number such please available copyright support message after best
software then good video well where info rights public books high school
through each links she review years order very privacy book items company read
group need many user said does set under general research university january
mail full map reviews program life know games way days management part could
great united hotel real item international center ebay must store travel
comments made development report off member details line terms before hotels
did send right type because local those using results office education
national car design take posted internet address community within states area
want phone shipping reserved subject between forum family long based code show
even black check special prices website index being women much sign file link
open today technology south case project same pages version section own found
sports house related security both county american photo game members power
while care network down computer systems three total place end following
download him without per access think north resources current posts big media
law control water history pictures size art personal since including guide
shop directory board location change white text small rating rate government
children during return students shopping account times sites level digital
profile previous form events love old john main call hours image department
title description non insurance another why shall property class cd still
money quality every listing content country private little visit save tools
low reply customer december compare movies include college value article york
man card jobs provide food source author different press learn sale around
print course canada process teen room stock training too credit point join
science men categories advanced west sales look english left team estate box
conditions select windows photos gay thread week category note live large
gallery table register however june october november market library really
action start series model features air industry plan human provided tv yes
required second hot accessories cost movie forums march la september better
say questions july yahoo going medical test friend come dec server pc study
application cart staff articles san feedback again play looking issues april
never users complete street topic comment financial things working against
standard tax person below mobile less got blog party payment equipment login
student let programs offers legal above recent park stores side act problem
red give memory performance social august quote language story sell options
experience rates create key body young america important field few east paper
single age activities club example girls additional password latest something
road gift question changes night hard texas oct pay four poker status browse
issue range building seller court february always result audio light write
war nov offer blue groups al easy given files event release analysis request
fax china making picture needs possible might professional yet month major
star areas future space committee hand sun cards problems london washington
meeting rss become interest id child keep enter california share similar
garden schools million added reference companies listed baby learning energy
run delivery net popular term film stories put computers journal reports co
try welcome central images president notice god original head radio until cell
color self council away includes track australia discussion archive once
others entertainment agreement format least society months log safety friends
sure faq trade edition cars messages marketing tell further updated
association able having provides david fun already green studies close common
drive specific several gold feb living sep collection called short arts lot
ask display limited powered solutions means director daily beach past natural
whether due et electronics five upon period planning database says official
weather mar land average done technical window france pro region island record
direct microsoft conference environment records st district calendar costs
style url front statement update parts aug ever downloads early miles sound
resource present applications either ago document word works material bill
apr written talk federal hosting rules final adult tickets thing centre
requirements via cheap kids finance true minutes else mark third rock gifts
europe reading topics bad individual tips plus auto cover usually edit
together videos percent fast function fact unit getting global tech meet far
economic en player projects lyrics often subscribe submit germany amount
watch included feel though bank risk thanks everything deals various words
linux jul production commercial james weight town heart advertising received
choose treatment newsletter archives points knowledge magazine error camera
jun girl currently construction toys registered clear golf receive domain
methods chapter makes protection policies loan wide beauty manager india
position taken sort listings models michael known half cases step engineering
florida simple quick none wireless license paul friday lake whole annual
published later basic sony shows corporate church method purchase customers
active response practice hardware figure materials fire holiday chat enough
designed along among death writing speed html countries loss face brand
discount higher effects created remember standards oil bit yellow political
increase advertise kingdom base near environmental thought stuff french
storage japan doing loans shoes entry stay nature orders availability africa
summary turn mean growth notes agency king monday european activity copy
although drug pics western income force cash employment overall bay river
commission ad package contents seen players engine port album regional stop
supplies started administration bar institute views plans double dog build
screen exchange types soon sponsored lines electronic continue across benefits
needed season apply someone held ny anything printer condition effective
believe organization effect asked eur mind sunday selection casino pdf lost
tour menu volume cross anyone mortgage hope silver corporation wish inside
solution mature role rather weeks addition came supply nothing certain usr
executive running lower necessary union jewelry according dc clothing mon com
particular fine names robert homepage hour gas skills six bush islands advice
career military rental decision leave british teens pre huge sat woman
facilities zip bid kind sellers middle move cable opportunities taking values
division coming tuesday object lesbian appropriate machine logo length
actually nice score statistics client ok returns capital follow sample
investment sent shown saturday christmas england culture band flash ms lead
george choice went starting registration fri thursday courses consumer hi
airport foreign artist outside furniture levels channel letter mode phones
ideas wednesday structure fund summer allow degree contract button releases
wed homes super male matter custom virginia almost took located multiple asian
distribution editor inn industrial cause potential song cnet ltd los hp focus
late fall featured idea rooms female responsible inc communications win
associated thomas primary cancer numbers reason tool browser spring foundation
answer voice eg friendly schedule documents communication purpose feature bed
comes police everyone independent approach cameras brown physical operating
hill maps medicine deal hold ratings chicago forms glass happy tue smith
wanted developed thank safe unique survey prior telephone sport ready feed
animal sources mexico population pa regular secure navigation operations
therefore ass simply evidence station christian round paypal favorite
understand option master valley recently probably thu rentals sea built
publications blood cut worldwide improve connection publisher hall larger
anti networks earth parents nokia impact transfer introduction kitchen strong
tel carolina wedding properties hospital ground overview ship accommodation
owners disease excellent paid italy perfect hair opportunity kit classic
basis command cities william express anal award distance tree peter assessment
ensure thus wall ie involved el extra especially interface pussy partners
budget rated guides success maximum ma operation existing quite selected boy
amazon patients restaurants beautiful warning wine locations horse vote
forward flowers stars significant lists technologies owner retail animals
useful directly manufacturer ways est son providing rule mac housing takes
iii gmt bring catalog searches max trying mother authority considered told
xml traffic programme joined input strategy feet agent valid bin modern
senior ireland sexy teaching door grand testing trial charge units instead
canadian cool normal wrote enterprise ships entire educational md leading
metal positive fl fitness chinese opinion mb asia football abstract uses
output funds mr greater likely develop employees artists alternative
processing responsibility resolution java guest seems publication pass
relations trust van contains session multi photography republic fees
components vacation century academic assistance completed skin graphics
indian prev ads mary il expected ring grade dating pacific mountain
organizations pop filter mailing vehicle longer consider int northern behind
panel floor german buying match proposed default require iraq boys outdoor
deep morning otherwise allows rest protein plant reported hit transportation
mm pool mini politics partner disclaimer authors boards faculty parties fish
membership mission eye string sense modified pack released stage internal
goods recommended born unless richard detailed japanese race approved
background target except character usb maintenance ability maybe functions
ed moving brands places php pretty trademarks phentermine spain southern
yourself etc winter battery youth pressure submitted boston debt keywords
medium television interested core break purposes throughout sets dance wood
msn itself defined papers playing awards fee studio reader virtual device
established answers rent las remote dark programming external apple le
regarding instructions min offered theory enjoy remove aid surface minimum
visual host variety teachers isbn martin manual block subjects agents
increased repair fair civil steel understanding songs fixed wrong beginning
hands associates finally az updates desktop classes paris ohio gets sector
capacity requires jersey un fat fully father electric saw instruments quotes
officer driver businesses dead respect unknown specified restaurant mike
trip pst worth mi procedures poor teacher xxx eyes relationship workers farm
fucking georgia peace traditional campus tom showing creative coast benefit
progress funding devices lord grant sub agree fiction hear sometimes
watches careers beyond goes families led museum themselves fan transport
interesting blogs wife evaluation accepted former implementation ten hits
zone complex th cat galleries references die presented jack flat flow agencies
literature respective parent spanish michigan columbia setting dr scale stand
economy highest helpful monthly critical frame musical definition secretary
angeles networking path australian employee chief gives kb bottom magazines
packages detail francisco laws changed pet heard begin individuals colorado
royal clean switch russian largest african guy titles relevant guidelines
justice connect bible dev cup basket applied weekly vol installation
described demand pp suite vegas na square chris attention advance skip diet
army auction gear lee os difference allowed correct charles nation selling
lots piece sheet firm seven older illinois regulations elements species
jump cells module resort facility random pricing dvds certificate minister
motion looks fashion directions visitors documentation monitor trading forest
calls whose coverage couple giving chance vision ball ending clients actions
listen discuss accept automotive naked goal successful sold wind communities
clinical situation sciences markets lowest highly publishing appear emergency
developing lives currency leather determine temperature palm announcements
patient actual historical stone bob commerce ringtones perhaps persons
difficult scientific satellite fit tests village accounts amateur ex met
pain xbox particularly factors coffee www settings buyer cultural steve
easily oral ford poster edge functional root au fi closed holidays ice pink
zealand balance monitoring graduate replies shot nc architecture initial
label thinking scott llc sec recommend canon league waste minute bus provider
optional dictionary cold accounting manufacturing sections chair fishing
effort phase fields bag fantasy po letters motor va professor context install
shirt apparel generally continued foot mass crime count breast techniques
ibm rd johnson sc quickly dollars websites religion claim driving permission
surgery patch heat wild measures generation kansas miss chemical doctor task
reduce brought himself nor component enable exercise bug santa mid guarantee
leader diamond israel se processes soft servers alone meetings seconds jones
arizona keyword interests flight congress fuel username walk fuck produced
italian paperback classifieds wait supported pocket saint rose freedom
argument competition creating jim drugs joint premium providers fresh
characters attorney upgrade di factor growing thousands km stream apartments
pick hearing eastern auctions therapy entries dates generated signed upper
administrative serious prime samsung limit began louis steps errors shops
del efforts informed ga ac thoughts creek ft worked quantity urban practices
sorted reporting essential myself tours platform load affiliate labor
immediately admin nursing defense machines designated tags heavy covered
recovery joe guys integrated configuration merchant comprehensive expert
universal protect drop solid cds presentation languages became orange
compliance vehicles prevent theme rich im campaign marine improvement vs
guitar finding pennsylvania examples ipod saying spirit ar claims challenge
motorola acceptance strategies mo seem affairs touch intended towards sa
goals hire election suggest branch charges serve affiliates reasons magic
mount smart talking gave ones latin multimedia xp avoid certified manage
corner rank computing oregon element birth virus abuse interactive requests
separate quarter procedure leadership tables define racing religious facts
breakfast kong column plants faith chain developer identify avenue missing
died approximately domestic sitemap recommendations moved houston reach
comparison mental viewed moment extended sequence inch attack sorry centers
opening damage lab reserve recipes cvs gamma plastic produce snow placed
truth counter failure follows eu weekend dollar camp ontario automatically
des minnesota films bridge native fill williams movement printing baseball
owned approval draft chart played contacts cc jesus readers clubs lcd wa jackson
equal adventure matching offering shirts profit leaders posters institutions
assistant variable ave dj advertisement expect parking headlines yesterday
compared determined wholesale workshop russia gone codes kinds extension
seattle statements golden completely teams fort cm wi lighting senate forces
funny brother gene turned portable tried electrical applicable disc returned
pattern ct hentai boat named theatre laser earlier manufacturers sponsor
classical icon warranty dedicated indiana direction harry basketball objects
ends delete evening assembly nuclear taxes mouse signal criminal issued brain
sexual wisconsin powerful dream obtained false da cast flower felt personnel
passed supplied identified falls pic soul aids opinions promote stated
stats hawaii professionals appears carry flag decided nj covers hr em
advantage hello designs maintain tourism priority newsletters adults clips
savings iv graphic atom payments rw estimated binding brief ended winning
eight anonymous iron straight script served wants miscellaneous prepared void
dining alert integration atlanta dakota tag interview mix framework disk
installed queen vhs credits clearly fix handle sweet desk criteria pubmed dave
massachusetts diego hong vice associate ne truck behavior enlarge ray
frequently revenue measure changing votes du duty looked discussions bear
gain festival laboratory ocean flights experts signs lack depth iowa whatever
logged laptop vintage train exactly dry explore maryland spa concept nearly
eligible checkout reality forgot handling origin knew gaming feeds billion
destination scotland faster intelligence dallas bought con ups nations route
followed specifications broken tripadvisor frank alaska zoom blow battle
residential anime speak decisions industries protocol query clip partnership
editorial nt expression es equity provisions speech wire principles suggestions
rural shared sounds replacement tape strategic judge spam economics acid
bytes cent forced compatible fight apartment height null zero speaker filed
gb netherlands obtain bc consulting recreation offices designer remain
managed pr failed marriage roll korea banks fr participants secret bath aa
kelly leads negative austin favorites toronto theater springs missouri andrew
var perform healthy translation estimates font assets injury mt joseph
ministry drivers lawyer figures married protected proposal sharing philadelphia
portal waiting birthday beta fail gratis banking officials brian toward won
slightly assist conduct contained lingerie legislation calling parameters
jazz serving bags profiles miami comics matters houses doc postal relationships
tennessee wear controls breaking combined ultimate wales representative frequency
introduced minor finish departments residents noted displayed mom reduced
physics rare spent performed extreme samples davis daniel bars reviewed row oz
forecast removed helps singles administrator cycle amounts contain accuracy
dual rise usd sleep mg bird pharmacy brazil creation static scene hunter
addresses lady crystal famous writer chairman violence fans oklahoma speakers
drink academy dynamic gender eat permanent agriculture dell cleaning
constitutes portfolio practical delivered collectibles infrastructure exclusive
seat concerns colour vendor originally intel utilities philosophy regulation
officers reduction aim bids referred supports nutrition recording regions
junior toll les cape ann rings meaning tip secondary wonderful mine ladies
henry ticket announced guess agreed prevention whom ski soccer math import
posting presence instant mentioned automatic healthcare viewing maintained ch
increasing majority connected christ dan dogs sd directors aspects austria ahead
moon participation scheme utility preview fly manner matrix containing
combination devel amendment despite strength guaranteed turkey libraries
proper distributed degrees singapore enterprises delta fear seeking inches
phoenix rs convention shares principal daughter standing voyeur comfort
colors wars cisco ordering kept alpha appeal cruise bonus certification
previously hey bookmark buildings specials beat disney household batteries
adobe smoking bbc becomes drives arms alabama tea improved trees avg achieve
positions dress subscription dealer contemporary sky utah nearby rom carried
happen exposure panasonic hide permalink signature gambling refer miller
provision outdoors clothes caused luxury babes frames certainly indeed
newspaper toy circuit layer printed slow removal easier src liability trademark
hip printers faqs nine adding kentucky mostly eric spot taylor trackback
prints spend factory interior revised grow americans optical promotion relative
amazing clock dot hiv identity suites conversion feeling hidden reasonable
victoria serial relief revision broadband influence ratio pda importance rain
onto dsl planet webmaster copies recipe zum permit seeing proof dna diff tennis
bass prescription bedroom empty instance hole pets ride licensed orlando
specifically tim bureau maine sql represent conservation pair ideal specs
recorded don pieces finished parks dinner lawyers sydney stress cream ss runs
trends yeah discover ap patterns boxes louisiana hills javascript fourth nm
advisor mn marketplace nd evil aware wilson shape evolution irish certificates
objectives stations suggested gps op remains acc greatest firms concerned
euro operator structures generic encyclopedia usage cap ix scheduled downtown
nyc nodes computation hopefully daddy uk motors demonstrate pocket grid""".split()

_DEFAULT_TOTAL = 1024908267229.0  # corpus scale used for OOV penalty


class Segmenter:
    """Viterbi word segmentation with Zipf-smoothed unigram scores."""

    MAX_WORD_LEN = 24

    def __init__(self):
        self.unigrams: Dict[str, float] = {}
        n = len(_COMMON)
        for rank, w in enumerate(_COMMON, start=1):
            # Zipf pseudo-counts anchored near the real frequency scale
            self.unigrams[w] = 2.2e10 / rank
        # subtitle-domain + conversational supplement (the base list is a
        # written-register corpus; hard subtitles skew conversational)
        for w in ("subtitle", "ok", "okay", "yeah", "hey", "gonna", "wanna",
                  "gotta", "dont", "cant", "wont", "didnt", "isnt", "im",
                  "ive", "youre", "thats", "whats", "lets"):
            self.unigrams.setdefault(w, 2.2e10 / (n / 2))
        # regular inflections at a discount: the base list is ~3k lemmas, so
        # plurals/participles ('jumps', 'subtitles') were OOV and the
        # Viterbi path preferred leaving chunks unsplit
        for w, c in list(self.unigrams.items()):
            forms = {w + "s": c / 4.0, w + "es": c / 8.0, w + "ed": c / 6.0,
                     w + "ing": c / 6.0}
            if w.endswith("e"):
                forms[w[:-1] + "ing"] = c / 6.0
                forms[w + "d"] = c / 6.0
            if w.endswith("y") and len(w) > 2:
                forms[w[:-1] + "ies"] = c / 6.0
            for f, fc in forms.items():
                if f not in self.unigrams:
                    self.unigrams[f] = fc
        self.total = max(_DEFAULT_TOTAL, sum(self.unigrams.values()))

    def score(self, word: str) -> float:
        """Log10 unigram probability with the OOV length penalty."""
        if word in self.unigrams:
            return math.log10(self.unigrams[word] / self.total)
        # unknown-word penalty grows with length
        return math.log10(10.0 / (self.total * 10 ** len(word)))

    def segment(self, text: str) -> List[str]:
        """Split alphanumeric runs into likely words; punctuation and
        non-ASCII chunks pass through untouched."""
        clean = "".join(c.lower() if c.isalnum() else " " for c in text)
        out: List[str] = []
        for chunk in clean.split():
            if not chunk.isascii():
                out.append(chunk)
                continue
            out.extend(self._segment_chunk(chunk))
        return out

    def _segment_chunk(self, chunk: str) -> List[str]:
        n = len(chunk)
        if n == 0:
            return []
        best = [(-1e18, 0)] * (n + 1)
        best[0] = (0.0, 0)
        for i in range(1, n + 1):
            lo = max(0, i - self.MAX_WORD_LEN)
            b = (-1e18, 0)
            for j in range(lo, i):
                cand = best[j][0] + self.score(chunk[j:i])
                if cand > b[0]:
                    b = (cand, j)
            best[i] = b
        words: List[str] = []
        i = n
        while i > 0:
            j = best[i][1]
            words.append(chunk[j:i])
            i = j
        return list(reversed(words))
